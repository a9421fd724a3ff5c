"""Device time per step of the kernels launched inside autograd's
`evaluate_function` spans, matched to their launches by correlation id:
the train step's backward pass."""


def read(ctx):
    s = ctx.trace.kernel_s(backward=True)
    return 1e3 * s / ctx.n if s > 0 else None
