"""Device ms per step of the collectives on rank 0: every kernel launched
inside one of the program's `rt.ranks.*` spans (the slots' all-gather,
the gradient buckets' all-reduces and the waits for them, the loss's and
the counters' all-reduces), by correlation id (harness/spans.py); a
collective's kernel counts from its launch to its end, its wait for the
other ranks included. Nothing when no such span held a kernel."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    s = sum(c[1] for c in sp.charges
            if any(n.startswith("rt.ranks.") for n in c[0]))
    return 1e3 * s / ctx.n if s > 0 else None
