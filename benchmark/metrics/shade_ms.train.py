"""Device ms per step charged to the program's `rt.integrator.shade`
span as the innermost one (surface data, colours, maps and the lighting
arithmetic of each bounce block; the occlusion queries inside it are
`rt.integrator.shadow`'s), forward and backward: a backward kernel is
charged where its forward operator ran (harness/spans.py). Nothing when
the span never ran."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if not sp.count("rt.integrator.shade"):
        return None
    return 1e3 * sp.kernel_s("rt.integrator.shade") / ctx.n
