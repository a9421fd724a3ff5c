"""Device ms per frame of the SSAA pass: every kernel launched inside
the program's `rt.pipeline.ssaa` span (the Sobel mask, the queue, its
bounce loop and scatter), by correlation id (harness/spans.py). Nothing
when the span never ran."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if not sp.count("rt.pipeline.ssaa"):
        return None
    return 1e3 * sp.kernel_s("rt.pipeline.ssaa", inclusive=True) / ctx.n
