"""Device time per request of PyTorch's own kernels (launched from
inside an aten:: operator): the integrator's shading, sorts and the
intersection pre-pass, and their backward."""


def read(ctx):
    s = ctx.trace.kernel_s(torch_side=True)
    return 1e3 * s / ctx.n if s > 0 else None
