"""The share of the SSAA queue's lanes that are fill (no masked pixel
behind them): 100 x (`ssaa_lanes` - `ssaa_masked`) / `ssaa_lanes`, the
program's counters (rendering_tpu_torch.utils.tracing) over the traced
requests. Nothing when the program keeps no such counters."""


def read(ctx):
    try:
        from rendering_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("ssaa_lanes"):
        return None
    return 100.0 * (c["ssaa_lanes"] - c.get("ssaa_masked", 0)) / c["ssaa_lanes"]
