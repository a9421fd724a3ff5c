"""The Triton twin of the K7 probe (`ops.microbench.fma_chain_triton`).

This module imports `triton` at the top, so only the launcher in
`ops/microbench.py` imports it, at the first launch on a card; the rest
of the package, and every CPU test, never does.

The kernel is K7's fused variant written for a second code generator:
Triton keeps its FP fusion on by default, so `acc * a + b` (and
`x * 1.000001 + 0.3`) become FMAs, which pairs it with
`csrc/microbench.cu`'s FUSED=true and with the Pallas kernel as its
interpret mode runs it. Each program takes BLOCK elements of the block;
the grid repeats the block `grid` times, as the CUDA kernel does.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl

BLOCK = 256
NUM_WARPS = 8   # one element per thread, as the CUDA kernel's 256 threads


@triton.jit
def _fma_chain_kernel(x_ptr, o_ptr, n, inner, blocks_per_step,
                      N_CHAINS: tl.constexpr, BLOCK: tl.constexpr):
    offs = (tl.program_id(0) % blocks_per_step) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    a = x * 1.000001 + 0.3
    b = x * 0.999999 - 0.3
    # x + 0.01 * c in f32 (the constants as numpy rounds 0.01 * c).
    acc0 = x + 0.0
    acc1 = x + 0.01
    acc2 = x + 0.02
    acc3 = x + 0.03
    acc4 = x + 0.04
    acc5 = x + 0.05
    acc6 = x + 0.06
    acc7 = x + 0.07
    for _ in range(inner):
        acc0 = acc0 * a + b
        if N_CHAINS > 1:
            acc1 = acc1 * a + b
        if N_CHAINS > 2:
            acc2 = acc2 * a + b
        if N_CHAINS > 3:
            acc3 = acc3 * a + b
        if N_CHAINS > 4:
            acc4 = acc4 * a + b
        if N_CHAINS > 5:
            acc5 = acc5 * a + b
        if N_CHAINS > 6:
            acc6 = acc6 * a + b
        if N_CHAINS > 7:
            acc7 = acc7 * a + b
    out = acc0
    if N_CHAINS > 1:
        out = out + acc1
    if N_CHAINS > 2:
        out = out + acc2
    if N_CHAINS > 3:
        out = out + acc3
    if N_CHAINS > 4:
        out = out + acc4
    if N_CHAINS > 5:
        out = out + acc5
    if N_CHAINS > 6:
        out = out + acc6
    if N_CHAINS > 7:
        out = out + acc7
    tl.store(o_ptr + offs, out, mask=mask)


def launch_fma_chain(x: torch.Tensor, out: torch.Tensor, *, inner: int,
                     grid: int, n_chains: int) -> None:
    """One launch over x's n elements, the block repeated `grid` times."""
    per_step = triton.cdiv(x.numel(), BLOCK)
    _fma_chain_kernel[(per_step * grid,)](
        x, out, x.numel(), inner, per_step, N_CHAINS=n_chains, BLOCK=BLOCK,
        num_warps=NUM_WARPS)
