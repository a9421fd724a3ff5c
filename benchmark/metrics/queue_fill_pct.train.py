"""The share of the continuation queue's lanes that carry a live path on
bounces 1 and later: 100 x `queue_live_lanes` / `queue_lanes`, the
program's counters (rendering_tpu_torch.utils.tracing) over the traced
steps. Nothing when the program keeps no such counters."""


def read(ctx):
    try:
        from rendering_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("queue_lanes"):
        return None
    return 100.0 * c.get("queue_live_lanes", 0) / c["queue_lanes"]
