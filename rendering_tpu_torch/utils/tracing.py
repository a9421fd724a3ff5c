"""Program spans and counters on the profiler's clock.

`span(name)` marks a stage of the port. While a `torch.profiler` session
records, it enters `torch.profiler.record_function(name)`, so the stage
is a `user_annotation` event of the same Chrome trace as the device's
kernels: every kernel's launch (matched by correlation id) and every
idle interval of the device falls inside named stages, on the clock
CUPTI aligns with the device timeline. With no session recording, the
cost is one attribute read: `span` returns one shared no-op context and
builds nothing (a `record_function` built while the profiler is off
still costs ~10 us on the host).

Names are `rt.<layer>.<stage>`, dotted: `rt.train.step`, `rt.render`
and `rt.cli.main` are the roots of a request; `rt.sync.<site>` marks
each read that blocks the host on the device. None starts with `aten::`
or `autograd::`, so operators and spans stay apart in a trace.

`count(name, value)` adds to a counter, only while a session records: a
host int, or a tensor whose elements are summed on its device (detached,
no host read). `counters()` returns the totals as host numbers, reading
the device once (after the caller's own synchronize). The counts are
those since the last `reset()`: a process that records one session, as
the benchmark's traced run does, counts that session, and
`utils.profiling.trace` resets at the start of each of its captures.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _prof

_OFF = contextlib.nullcontext()

_counts: dict = {}


def span(name: str):
    """A context marking the block as stage `name` in a recorded trace;
    the shared no-op context when no session records."""
    if not _prof._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: the function's calls run inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add `value` (a host int, or a tensor summed on its device) to
    counter `name` while a session records; nothing otherwise."""
    if not _prof._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    _counts.setdefault(name, []).append(value)


def reset() -> None:
    """Drop every count: the next ones start from zero."""
    _counts.clear()


def counters() -> dict:
    """{name: total} of the counts kept, as host numbers: one read of the
    device for all counters on it. Call after the device has finished
    the counted work."""
    totals = {name: sum(v for v in vals if not isinstance(v, torch.Tensor))
              for name, vals in _counts.items()}
    on_device: dict = {}
    for name, vals in _counts.items():
        for v in vals:
            if isinstance(v, torch.Tensor):
                on_device.setdefault(v.device, {}).setdefault(name, []).append(
                    v.to(torch.float64))
    for group in on_device.values():
        names = list(group)
        sums = torch.stack([torch.stack(group[n]).sum() for n in names])
        for n, s in zip(names, sums.tolist()):
            totals[n] += int(s) if float(s).is_integer() else s
    return totals
