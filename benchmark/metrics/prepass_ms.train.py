"""Device ms per request of the intersection pre-pass: the kernels
launched inside the program's `rt.intersect.prepass` span
(`ops/cuda_intersect.prepare`: padding, the per-tile slab tests and
visit order, the tile schedule), by correlation id (harness/spans.py).
Nothing when the span never ran."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if not sp.count("rt.intersect.prepass"):
        return None
    return 1e3 * sp.kernel_s("rt.intersect.prepass", inclusive=True) / ctx.n
