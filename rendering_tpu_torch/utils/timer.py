"""Phase wall-clock timers — the port's copy of `rendering_tpu.utils.timer`,
the analogue of the reference's RAII Timer (`include/timer.h:8-40`).

A timer on a CUDA device synchronizes the device before it reads the
clock, so the phase's queued kernels are inside its time. It prints
`<name> <ms> ms` when `enable_output` is set (the reference's
`options::enableOutput`).
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self, name: str = "Unnamed timer:", enable_output: bool = True,
                 device=None):
        self.name = name
        self.enable_output = enable_output
        self.device = torch.device(device) if device is not None else None
        self.start = time.perf_counter()
        self.elapsed_ms: float | None = None
        self._running = True

    def stop(self) -> float:
        if not self._running:
            return self.elapsed_ms or 0.0
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._running = False
        self.elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        if self.enable_output:
            print(f"{self.name:<18}{self.elapsed_ms:.0f} ms")
        return self.elapsed_ms
