"""Host synchronize calls per frame that the program makes: the CUDA
runtime's cudaStreamSynchronize, cudaEventSynchronize and
cudaDeviceSynchronize calls of the window that lie inside the program's
`rt.` spans (harness/spans.py), which leaves out the harness's own
window-end synchronize. The `rt.sync.` spans name the sites; this counts
the calls, however many one site makes. Nothing when no program span
ran."""

from harness import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if not sp.count(spans.PREFIX):
        return None
    return sum(1 for _, _, held in sp.syncs() if held) / ctx.n
