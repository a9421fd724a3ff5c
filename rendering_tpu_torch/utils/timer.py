"""Phase wall-clock timers — the port's copy of `rendering_tpu.utils.timer`,
the analogue of the reference's RAII Timer (`include/timer.h:8-40`).

A timer on a CUDA device synchronizes the device before it reads the
clock, so the phase's queued kernels are inside its time. It prints
`<name> <ms> ms` when `enable_output` is set (the reference's
`options::enableOutput`).

`phase_timer` is the context-manager form, recording into a dict.
Given `span`, both mark their phase as that stage span of a recorded
trace (`utils.tracing`); a timer around a function that opens its own
span names none. The synchronize is the span `rt.sync.timer`.

`mean_ms` times a function over repeats: CUDA events on a card, the host
clock on the CPU. Every time the port's tools and `chip_smoke.py` report
comes from it.
"""

from __future__ import annotations

import contextlib
import time

import torch

from rendering_tpu_torch.utils import tracing


class Timer:
    def __init__(self, name: str = "Unnamed timer:", enable_output: bool = True,
                 device=None, span: str | None = None):
        self.name = name
        self.enable_output = enable_output
        self.device = torch.device(device) if device is not None else None
        self.start = time.perf_counter()
        self.elapsed_ms: float | None = None
        self._running = True
        self._span = tracing.span(span) if span else None
        if self._span is not None:
            self._span.__enter__()

    def stop(self) -> float:
        if not self._running:
            return self.elapsed_ms or 0.0
        if self.device is not None and self.device.type == "cuda":
            with tracing.span("rt.sync.timer"):
                torch.cuda.synchronize(self.device)
        self._running = False
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self.elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.enable_output:
            print(f"{self.name:<18}{self.elapsed_ms:.0f} ms")
        return self.elapsed_ms


@contextlib.contextmanager
def phase_timer(name: str, enable_output: bool = True,
                result: dict | None = None, device=None,
                span: str | None = None):
    """Time the block with a `Timer` (JAX `utils.timer.phase_timer`): on a
    CUDA `device` the timer synchronizes it before reading the clock, as
    the JAX timer blocks on its box["sync"] outputs, so work the block
    queued is inside the time. Records the milliseconds in result[name]
    when a dict is given, also when the block raises. Yields the timer."""
    t = Timer(name, enable_output, device=device, span=span)
    try:
        yield t
    finally:
        ms = t.stop()
        if result is not None:
            result[name] = ms


# ~2 ms of spinning at an H100's 1.98 GHz SM clock.
PRIME_CYCLES = 4_000_000


def mean_ms(fn, reps: int, device="cuda") -> float:
    """Mean milliseconds of fn() over `reps` calls after one warm-up call.

    On a card, by CUDA events, with a spin of ~2 ms (PRIME_CYCLES) queued
    before the start event: the host has queued the timed launches before
    the card reaches them, so the events time the launches back to back on
    the device, not the host's launch rate (~20 us a call through ctypes,
    more than a short kernel takes). A function that waits for the card
    (a host sync inside) waits out the spin before the start event, so
    the spin is never inside the time. On the CPU, the host clock: it
    times PyTorch's CPU kernels, never a device."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    torch.cuda._sleep(PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
