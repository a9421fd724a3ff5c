"""Device ms per frame of the deterministic radiance scatters: the
kernels launched inside the program's `rt.integrator.scatter` spans
(every `index_add` of radiance into a frame, `integrator._scatter` and
the SSAA pass's), by correlation id (harness/spans.py). Nothing when the
span never ran."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if not sp.count("rt.integrator.scatter"):
        return None
    return 1e3 * sp.kernel_s("rt.integrator.scatter", inclusive=True) / ctx.n
