"""The multi-device layer's collectives on torch.distributed: one axis of
a device mesh (`Comm`), the plain all-reduce and all-gather on it, the
two that carry a gradient, and the geometry-sharding combines.

Only all_reduce and all_gather are used, on the tensors as they are, so
the same code runs over NCCL (a card for each rank), over gloo on the
CPU, and over gloo with ranks that share one card (gloo takes CUDA
tensors for these collectives).

Gradients. Every rank computes the same loss from the same replicated
frame. A rank's backward must then hand each of its local contributions
exactly the cotangent of the replicated value it fed, not a sum over
ranks: `gather_slots` returns this rank's slice of the cotangent and
`sum_replicated` the cotangent itself. Each rank's parameter gradients
are then its share, and one SUM all-reduce of them over the ray ranks
(`parallel.overlap`) gives the gradient of the loss. The JAX package gets
this from shard_map's typing of varying and replicated values;
`torch.distributed.nn`'s all_reduce and all_gather sum the cotangent over
ranks in backward, which counts it once per rank.

In a recorded trace (`utils.tracing`) every all-reduce is the span
`rt.ranks.all_reduce` and every all-gather `rt.ranks.all_gather` (the
gradient buckets of `parallel.overlap` too).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from rendering_tpu_torch.utils.tracing import span

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclasses.dataclass(frozen=True)
class Comm:
    """One axis of a device mesh as this rank sees it: the process group
    (None when the axis has one rank, which needs no collective), this
    rank's index on the axis and the axis size."""

    group: object
    rank: int
    size: int


def single() -> Comm:
    """The axis of one rank: every collective returns its input."""
    return Comm(None, 0, 1)


def backend_device(comm: Comm) -> torch.device:
    """The device the axis's collectives take a new tensor on: the
    current card under NCCL, which takes no CPU tensor; else the CPU
    (gloo takes either)."""
    if dist.get_backend(comm.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _buffer(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x for a collective to write."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def all_reduce(comm: Comm, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The elementwise SUM, MIN or MAX of x over the axis (a new tensor;
    x is not written)."""
    if comm.size == 1:
        return x
    buf = _buffer(x)
    with span("rt.ranks.all_reduce"):
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]),
                        group=comm.group)
    return buf


def all_gather(comm: Comm, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along `dim` in rank
    order."""
    if comm.size == 1:
        return x
    buf = _buffer(x)
    parts = [torch.empty_like(buf) for _ in range(comm.size)]
    with span("rt.ranks.all_gather"):
        dist.all_gather(parts, buf, group=comm.group)
    return torch.cat(parts, dim=dim)


class _GatherSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        ctx.n = x.shape[-1]
        return all_gather(comm, x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.comm.rank * ctx.n
        return g[..., lo:lo + ctx.n], None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return all_reduce(comm, x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_slots(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """All-gather of each rank's slots (..., n) into (..., size * n) in
    rank order. Its backward returns this rank's slice of the cotangent
    (the replicated output feeds one loss that every rank computes)."""
    if comm.size == 1:
        return x
    return _GatherSlots.apply(x, comm)


def sum_replicated(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """SUM all-reduce into a value that every rank then uses identically;
    its backward is the identity."""
    if comm.size == 1:
        return x
    return _SumReplicated.apply(x, comm)


def all_reduce_stats(comm: Comm, stats: dict) -> dict:
    """The render counters summed over the axis in one all-reduce (as
    float64, exact for counts below 2^53): rays_casted a float tensor,
    the others int64 tensors. Counters that are all host numbers go on
    the backend's device (`backend_device`)."""
    if comm.size == 1:
        return stats
    keys = list(stats)
    dev = next((v.device for v in stats.values()
                if isinstance(v, torch.Tensor)), None) or backend_device(comm)
    packed = torch.stack([torch.as_tensor(stats[k], dtype=torch.float64,
                                          device=dev).reshape(())
                          for k in keys])
    packed = all_reduce(comm, packed, "sum")
    return {k: (v if k == "rays_casted" else v.to(torch.int64))
            for k, v in zip(keys, packed)}


# ---- geometry sharding: each rank of the geo axis holds a slice of the
# fused tables and queried the same rays against it --------------------


@torch.no_grad()
def combine_closest(comm: Comm, t, mid, vid, counters):
    """Each ray's closest hit over the geo axis (JAX
    `integrator.py:307-332`): a MIN all-reduce of t, then a MIN of the
    rank among the ranks whose t equals it (the first rank wins: rank
    order is global super order), then a SUM of mid/vid masked to the
    winner, and the counters summed. A miss (t = FMAX on every rank)
    keeps rank 0's mid = -1, vid = 0. Returns (mid, vid, counters)."""
    if comm.size == 1:
        return mid, vid, counters
    tmin = all_reduce(comm, t, "min")
    is_win = t == tmin
    win_rank = all_reduce(
        comm, torch.where(is_win, comm.rank, 2 ** 30).to(torch.int32), "min")
    sel = is_win & (win_rank == comm.rank)
    q = t.shape[0]
    packed = torch.cat([torch.where(sel, mid, 0).to(torch.int64),
                        torch.where(sel, vid, 0).to(torch.int64),
                        *(c.reshape(1).to(torch.int64) for c in counters)])
    packed = all_reduce(comm, packed, "sum")
    mid = packed[:q].to(torch.int32)
    vid = packed[q:2 * q].to(torch.int32)
    return mid, vid, list(packed[2 * q:])


@torch.no_grad()
def combine_any(comm: Comm, occ, counters):
    """Occlusion over the geo axis (JAX `integrator.py:509-515`): a ray is
    occluded where any rank's shard occludes it; the counters sum. One
    SUM all-reduce. Returns (occ, counters)."""
    if comm.size == 1:
        return occ, counters
    q = occ.shape[0]
    packed = all_reduce(comm, torch.cat([
        occ.to(torch.int64), *(c.reshape(1).to(torch.int64)
                               for c in counters)]), "sum")
    return packed[:q] > 0, list(packed[q:])


@torch.no_grad()
def gather_sharded_rows(comm: Comm, vsh, vid):
    """The (30, Q) gather-table rows of global columns vid from a table
    sharded by columns over the geo axis (JAX `integrator.py:334-351`):
    each rank gathers the columns in its own range (the others read a
    clamped column, masked to zero) and one SUM all-reduce assembles the
    rows, exactly one rank contributing each."""
    lc = vsh.shape[1]
    loc = vid.long() - comm.rank * lc
    inb = (loc >= 0) & (loc < lc)
    rows = torch.where(inb[None, :], vsh[:, torch.clamp(loc, 0, lc - 1)], 0.0)
    return all_reduce(comm, rows, "sum")
