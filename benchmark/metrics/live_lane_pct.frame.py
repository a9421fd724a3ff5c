"""The share of bounce-block lanes that carry a live path (weight above
min_weight): 100 x `live_lanes` / `lanes`, the program's counters
(rendering_tpu_torch.utils.tracing) over the traced requests. Nothing
when the program keeps no such counters."""


def read(ctx):
    try:
        from rendering_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("lanes"):
        return None
    return 100.0 * c.get("live_lanes", 0) / c["lanes"]
