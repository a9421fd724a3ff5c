"""Device time per request of the port's hand-written kernels: every
kernel not launched from inside a PyTorch operator (harness/trace.py),
whatever its name. Nothing when none ran."""


def read(ctx):
    s = ctx.trace.kernel_s(torch_side=False)
    return 1e3 * s / ctx.n if s > 0 else None
