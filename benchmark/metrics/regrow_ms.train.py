"""Host ms per step inside the program's `rt.train.regrow` spans (the
compactions that enlarge a train step's held queue capacity), on the
profiler's clock over the traced steps: 0 once the capacities hold.
Nothing when the program keeps no continuation-queue counters (a
program without a growing queue)."""

from harness import spans


def read(ctx):
    try:
        from rendering_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    if not counters().get("queue_lanes"):
        return None
    sp = spans.of(ctx.trace)
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    us = sum(b - a for iv in sp.spans.values() for a, b, e in iv
             if e["name"] == "rt.train.regrow" and t0 <= a <= t1)
    return 1e-3 * us / ctx.n
