"""Deterministic index accumulation: `index_accumulate(accum, idx,
values)` returns accum (C, N) with each lane j of values (C, Q) added
into column idx[j], the ids repeating freely. The integrator takes it
for its radiance scatter into the frame and for the backward of its
per-object gathers (`gather_rows`), where the JAX package has XLA's
scatter-add (`.at[:, pix].add`) and the gathers' autograd scatter; no
Pallas kernel.

For CUDA tensors it is csrc/index_accumulate.cu: the ids stable-sorted
by PyTorch's radix sort, then fixed chunks of THREADS x `slice_lanes(Q)`
sorted lanes a CTA, each thread summing its slice of lanes in order, a
segmented scan over the CTA joining the slices, and a second launch
joining the runs that cross chunks, in chunk order. The order of every
sum follows from the ids and Q alone, so repeat frames and train steps
are bit-equal on a card, with no atomics and no host sync; its launches
count in `KERNELS["index_accumulate"]` and its lanes in the tracing
counter `accum_lanes`. `index_accumulate_plain` repeats that order in
plain PyTorch, for the card's tests and `chip_smoke.py` to hold the
kernel to bit for bit. For CPU tensors it is `index_add`, which adds in
lane order: what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch
import torch.nn.functional as F

from rendering_tpu_torch.utils import nvcc, tracing

SOURCE = os.path.join(nvcc.CSRC, "index_accumulate.cu")
THREADS = 256        # a chunk's CTA: one slice of lanes a thread
CARRY_THREADS = 1024  # the carry pass's CTA, one a channel
MAX_SLICE = 8
# The fewest chunks a slice length may leave: two CTAs for each of an
# H100's 132 SMs.
MIN_CHUNKS = 264


@dataclasses.dataclass
class Launches:
    """Launch count of one kernel."""

    name: str
    launches: int = 0


KERNELS = {"index_accumulate": Launches("index_accumulate")}


def slice_lanes(q: int) -> int:
    """Lanes a thread sums in order for Q lanes: the most, up to
    MAX_SLICE, that still leave MIN_CHUNKS chunks of THREADS slices."""
    s = 1
    while s < MAX_SLICE and q >= 2 * s * THREADS * MIN_CHUNKS:
        s *= 2
    return s


def _seg_scan(x, g):
    """Inclusive segmented scan along the last dim, the kernel's
    `seg_scan`: step d adds the value d places back unless a segment
    start (g) lies between. Returns (sums, whether a start lies at or
    before each place)."""
    d = 1
    while d < x.shape[-1]:
        x_new, g_new = x.clone(), g.clone()
        x_new[..., d:] = torch.where(g[..., d:], x[..., d:],
                                     x[..., :-d] + x[..., d:])
        g_new[..., d:] = g[..., d:] | g[..., :-d]
        x, g = x_new, g_new
        d *= 2
    return x, g


def index_accumulate_plain(accum, idx, values):
    """The kernel's sums in plain PyTorch, in its order: accum (C, N) +
    values (C, Q) at columns idx (Q,), any float type. Returns a new
    tensor."""
    n_ch = accum.shape[0]
    q = idx.shape[0]
    out = accum.clone()
    if q == 0 or n_ch == 0:
        return out
    dev = accum.device
    s_l = slice_lanes(q)
    lanes = THREADS * s_l
    n_chunks = -(-q // lanes)
    keys, perm = torch.sort(idx.to(torch.int32), stable=True)
    keys = keys.long()
    pad = n_chunks * lanes - q
    none = keys.new_full((1,), -1)
    kp = torch.cat([keys, none.expand(pad)])
    shape = (n_chunks, THREADS, s_l)
    k3 = kp.reshape(shape)
    v4 = F.pad(values[:, perm], (0, pad)).reshape(n_ch, *shape)
    real = (torch.arange(n_chunks * lanes, device=dev) < q).reshape(shape)
    # Each thread's slice in order, restarting at each new key.
    a = v4[..., 0]
    accs = [a]
    for s in range(1, s_l):
        a = torch.where(k3[..., s] == k3[..., s - 1], a + v4[..., s],
                        v4[..., s])
        accs.append(a)
    acc = torch.stack(accs, -1)
    cnt = real.sum(-1)
    last = (cnt - 1).clamp_min(0)
    first_key = k3[..., 0]
    last_key = k3.gather(-1, last[..., None])[..., 0]
    prev_key = torch.cat([none, kp[:-1]]).reshape(shape)[..., 0]
    cont = ((torch.arange(THREADS, device=dev) > 0) & (cnt > 0)
            & (first_key == prev_key))
    g = ~(cont & (last_key == first_key))
    x = torch.where(cnt > 0, acc.gather(
        -1, last[None, ..., None].expand(n_ch, *shape[:2], 1))[..., 0], 0)
    sums, _ = _seg_scan(x, g.expand(n_ch, *shape[:2]))
    before = F.pad(sums[..., :-1], (1, 0))
    total = torch.where(cont[..., None] & (k3 == first_key[..., None]),
                        before[..., None] + acc, acc)
    end = real & (torch.cat([kp[1:], none]).reshape(shape) != k3)
    first = torch.arange(n_chunks, device=dev) * lanes
    last_lane = torch.clamp_max(first + lanes, q) - 1
    key_before = torch.where(first > 0, keys[(first - 1).clamp_min(0)], -1)
    from_before = k3 == key_before[:, None, None]
    direct = end & ~from_before
    kd = k3[direct]
    out[:, kd] = out[:, kd] + total[:, direct]
    if n_chunks == 1:
        return out
    # The runs that cross chunks: each chunk's last-lane sum scanned over
    # the chunks, tile by tile; a run's last chunk adds its head.
    tail = total.reshape(n_ch, -1)[:, last_lane]
    heads = end & from_before
    head = torch.zeros((n_ch, n_chunks), dtype=out.dtype, device=dev)
    chunk_of = torch.arange(n_chunks, device=dev)[:, None, None].expand(shape)
    head[:, chunk_of[heads]] = total[:, heads]
    gk = ~((first > 0) & (keys[last_lane] == key_before))
    n_tiles = -(-n_chunks // CARRY_THREADS)
    padc = n_tiles * CARRY_THREADS - n_chunks
    xt = F.pad(tail, (0, padc)).reshape(n_ch, n_tiles, CARRY_THREADS)
    gt = torch.cat([gk, gk.new_ones(padc)]).reshape(n_tiles, CARRY_THREADS)
    sums, started = _seg_scan(xt, gt.expand(n_ch, n_tiles, CARRY_THREADS))
    tiles = [sums[:, 0]]
    for t in range(1, n_tiles):
        tiles.append(torch.where(started[:, t], sums[:, t],
                                 tiles[-1][:, -1:] + sums[:, t]))
    scan = torch.cat(tiles, -1)
    k = torch.arange(1, n_chunks, device=dev)
    kf = keys[first[1:]]
    nxt = keys[torch.clamp_max(last_lane[1:] + 1, q - 1)]
    ends_here = ((keys[last_lane[1:]] != kf) | (last_lane[1:] + 1 == q)
                 | (nxt != kf))
    sel = (kf == key_before[1:]) & ends_here
    kk = k[sel]
    out[:, kf[sel]] = out[:, kf[sel]] + (scan[:, kk - 1] + head[:, kk])
    return out


_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = nvcc.build_library(SOURCE)
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ia_accumulate.argtypes = ([ptr] * 7 + [ctypes.c_longlong]
                                      + [i32] * 3 + [ptr])
        lib.ia_accumulate.restype = ctypes.c_int
        lib.ia_error_string.argtypes = [ctypes.c_int]
        lib.ia_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def index_accumulate_kernel(accum, idx, values):
    """The accumulation as csrc/index_accumulate.cu on contiguous CUDA
    tensors: accum (C, N) f32, idx (Q,) int32 or int64 in [0, N) (an id
    outside traps on the device), values (C, Q) f32. Returns a new
    tensor."""
    n_ch, n = accum.shape
    q = idx.shape[0]
    for name, x, dts, shape in (
            ("accum", accum, (torch.float32,), (n_ch, n)),
            ("idx", idx, (torch.int32, torch.int64), (q,)),
            ("values", values, (torch.float32,), (n_ch, q))):
        if not x.is_cuda or x.dtype not in dts or not x.is_contiguous():
            raise ValueError(f"index_accumulate: {name} must be a contiguous "
                             f"CUDA tensor of {dts}, got {x.dtype} on "
                             f"{x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"index_accumulate: {name} must have shape "
                             f"{shape}, got {tuple(x.shape)}")
    if q and not n:
        raise ValueError("index_accumulate: ids into an accumulator of no "
                         "columns")
    tracing.count("accum_lanes", q)
    out = accum.clone()
    if q == 0 or n_ch == 0:
        return out
    dev = accum.device
    keys, perm = torch.sort(idx.to(torch.int32), stable=True)
    s_l = slice_lanes(q)
    n_chunks = -(-q // (THREADS * s_l))
    scratch = torch.empty((3, n_ch, n_chunks), dtype=torch.float32,
                          device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ia_accumulate(keys.data_ptr(), perm.data_ptr(),
                               values.data_ptr(), out.data_ptr(),
                               *(s.data_ptr() for s in scratch), q, n, n_ch,
                               s_l, stream)
    if rc != 0:
        raise RuntimeError(f"index_accumulate launch failed: "
                           f"{lib.ia_error_string(rc).decode()}")
    KERNELS["index_accumulate"].launches += 1
    return out


class _Accumulate(torch.autograd.Function):
    """The kernel with index_add's gradients: the accumulator's passes
    through, the values' gathers its columns."""

    @staticmethod
    def forward(ctx, accum, idx, values):
        ctx.save_for_backward(idx)
        return index_accumulate_kernel(accum, idx, values)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g_values = (grad.index_select(1, idx) if ctx.needs_input_grad[2]
                    else None)
        return grad if ctx.needs_input_grad[0] else None, None, g_values


def index_accumulate(accum, idx, values):
    """accum (C, N) with values (C, Q) added at columns idx (Q,): the
    kernel for CUDA tensors, `index_add` (lane order) for CPU tensors;
    raises for another device. Differentiable in accum and values."""
    if accum.is_cuda:
        return _Accumulate.apply(accum.contiguous(), idx.contiguous(),
                                 values.contiguous())
    if accum.device.type != "cpu":
        raise ValueError(f"no index accumulation for device {accum.device}")
    return accum.index_add(1, idx, values)


class _GatherRows(torch.autograd.Function):
    """table[idx], or table.T[:, idx]; the backward adds the gradient's
    lanes into the table's rows through index_accumulate."""

    @staticmethod
    def forward(ctx, table, idx, transpose):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        ctx.transpose = transpose
        return table.T[:, idx] if transpose else table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = ctx.shape[0]
        if ctx.transpose:  # grad (F, Q)
            g = index_accumulate(grad.new_zeros((grad.shape[0], rows)), idx,
                                 grad)
            return g.T, None, None
        g2 = grad.reshape(idx.shape[0], -1).T  # (F, Q)
        g = index_accumulate(grad.new_zeros((g2.shape[0], rows)), idx, g2)
        return g.T.reshape(ctx.shape), None, None


def gather_rows(table, idx, *, transpose: bool = False):
    """table[idx] (with transpose, table.T[:, idx]) for a table (R, ...)
    and ids (Q,). For a table that requires grad, its gradient is added
    into the rows by `index_accumulate`; any other table is gathered as
    it is."""
    if not table.requires_grad:
        return table.T[:, idx] if transpose else table[idx]
    return _GatherRows.apply(table, idx, transpose)
