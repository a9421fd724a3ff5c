"""The hardware-ceiling probes: hand-written CUDA kernels for the f32
issue rate with and without FMA (K7), the cost of a grid's CTAs and of
its steps (K8) and the pair test's product in f32 and TF32 (K9), a
Triton twin of K7, and the plain PyTorch version of each.

K8 has two forms (csrc/microbench.cu): `grid_overhead` carries the TPU
grid over as one CTA per step, `grid_overhead_loop` takes the steps as a
loop inside persistent CTAs, as K9 does (`pair_product`, whose TF32 form
first packs the tables with `pack_tables`).

They replace the Pallas probes of the JAX package's tools
(`tools/microbench_vpu.py::_fma_bench`, `tools/microbench_kernel.py`'s
`bench_grid_overhead` and `bench_matmul`); `csrc/microbench.cu` says how
each TPU grid maps onto the card. `tools/microbench_vpu_torch.py` and
`tools/microbench_kernel_torch.py` drive them.

Every wrapper checks its tensors and takes the plain version for CPU
tensors; for CUDA tensors it launches the kernel or raises. Each kernel
counts its launches (`KERNELS`).

The card's data-sheet rates that every bound of the port is computed at
(`F32_FLOPS_RATE`, `F32_OPS_RATE`, `HBM_RATE`) are defined here, beside
the probes that measure what the card reaches.

One departure from the TPU kernels: K9's output starts from an explicit
`o_init`, where `_mm_kernel` read its output block before writing it
(uninitialised memory on the TPU; all NaN in interpret mode).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from rendering_tpu_torch.utils import nvcc

# The JAX tools' shapes (tools/microbench_vpu.py, microbench_kernel.py).
ROWS, LANES = 256, 1024     # K7's block
INNER = 4096                # chain steps per element
GRID = 64                   # repeats of the block
N_CHAINS = 6                # independent chains per element
N_TAB = 64                  # K9's distinct coef tables, cycled by s % 64
T_NONE = 3.0e38             # K9's "no accepted t"
PRECISIONS = ("highest", "default")
MAX_CHAINS = 8              # csrc/microbench.cu kMaxChains
MAX_K = 128                 # csrc/microbench.cu kMaxK
# csrc/microbench.cu: (row group, column tile) of K9's SIMT (highest)
# and tensor-core (default) kernels; tc and br must be multiples:
# kSimtChunk x kSimtCols, and kWgN x the wgmma kernel's widest column
# tile (4 warpgroups x 64 columns).
PAIR_TILES = {"highest": (32, 128), "default": (32, 256)}
WG_ROWS = 32                # csrc/microbench.cu kWgN: a packed chunk's rows
# K9 at default precision against its plain version (tf32_disagreement).
TF32_SUM_TOL = 1e-6
TF32_T_RTOL = 1e-3
TF32_MAX_FLIPS = 1 / 32

SOURCE = os.path.join(nvcc.CSRC, "microbench.cu")

# An H100 SXM's data-sheet rates, at which the port's bounds are stated:
# f32 with an FMA counted as two operations, and HBM. The kernels are
# built with -fmad=false, so every f32 multiply, add and compare issues
# on its own: one per lane per clock, 132 SMs x 128 lanes x 1.98 GHz =
# 33.5e12/s, half the FMA-counted rate.
F32_FLOPS_RATE = 67e12
F32_OPS_RATE = F32_FLOPS_RATE / 2
HBM_RATE = 3.35e12          # bytes/s


@dataclasses.dataclass
class Launches:
    """Launch count of one probe kernel."""

    name: str
    launches: int = 0


def pair_name(precision: str, epilogue: bool) -> str:
    """K9's launch count: `pair_product_<precision>[_epilogue]`."""
    return "pair_product_" + precision + ("_epilogue" if epilogue else "")


KERNELS = {name: Launches(name) for name in (
    "fma_chain_fused", "fma_chain_unfused", "fma_chain_triton",
    "grid_overhead", "grid_overhead_loop", "pair_pack_tf32",
    "pair_recurrence",
    *(pair_name(p, e) for e in (False, True) for p in PRECISIONS))}

_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = nvcc.build_library(SOURCE)
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mb_grid_overhead.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.mb_grid_overhead_loop.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.mb_fma_chain.argtypes = [ptr, ptr] + [i32] * 5 + [ptr]
        lib.mb_pack_tables.argtypes = [ptr, ptr] + [i32] * 3 + [ptr]
        lib.mb_pair_product.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.mb_pair_recurrence.argtypes = [ptr, ptr, i32, i32, ptr]
        for fn in (lib.mb_grid_overhead, lib.mb_grid_overhead_loop,
                   lib.mb_fma_chain, lib.mb_pack_tables, lib.mb_pair_product,
                   lib.mb_pair_recurrence):
            fn.restype = ctypes.c_int
        lib.mb_error_string.argtypes = [ctypes.c_int]
        lib.mb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, shape=None) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor, got "
                         f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no probe for device {x.device}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def _launch(kernel: str, fn, *args) -> None:
    """Call C entry point `fn` on the current stream of the tensors' card;
    raise if the launch failed, else count it."""
    lib = _library()
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.mb_error_string(rc).decode()}")
    KERNELS[kernel].launches += 1


# ---- K7: the FMA chains -----------------------------------------------------

def _fma(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """p * q + r rounded once to f32, for f32 values held in float64 (an
    FMA). The product is exact in float64; the sum is taken with round to
    odd (TwoSum's error nudges an inexact even result one ulp toward the
    exact value), after which rounding to f32 is correct: float64 keeps
    more than 24 + 2 bits. Non-finite sums keep IEEE's inf and NaN."""
    prod = p * q
    s = prod + r
    bb = s - prod
    err = (prod - (s - bb)) + (r - bb)
    nudge = ((err != 0) & ((s.view(torch.int64) & 1) == 0)
             & torch.isfinite(s))
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def fma_chain_plain(x: torch.Tensor, *, inner: int = INNER,
                    n_chains: int = N_CHAINS,
                    fused: bool = True) -> torch.Tensor:
    """K7's function of one block: a = x * 1.000001 + 0.3, b = x * 0.999999
    - 0.3, n_chains accumulators x + 0.01 * c, `inner` steps of
    acc = acc * a + b, then their sum in chain order. `fused` rounds each
    multiply-add once (as an FMA, which is what the Pallas kernel computes
    in interpret mode); else a multiply and an add, each rounded."""
    dev = x.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    if fused:
        x64 = x.double()
        a64 = _fma(x64, f32(1.000001).double(), f32(0.3).double()).double()
        b64 = _fma(x64, f32(0.999999).double(), f32(-0.3).double()).double()
    else:
        a = x * f32(1.000001) + f32(0.3)
        b = x * f32(0.999999) - f32(0.3)
    accs = torch.stack([x + f32(0.01 * c) for c in range(n_chains)])
    for _ in range(inner):
        accs = (_fma(accs.double(), a64, b64) if fused
                else accs * a + b)
    out = accs[0]
    for c in range(1, n_chains):
        out = out + accs[c]
    return out


def _check_chain(x, inner, grid, n_chains) -> None:
    _check("x", x)
    if x.numel() == 0 or inner < 0 or grid < 1 or not (
            1 <= n_chains <= MAX_CHAINS):
        raise ValueError(f"fma_chain: need a nonempty x, inner >= 0, grid "
                         f">= 1 and 1 <= n_chains <= {MAX_CHAINS}; got "
                         f"{x.numel()}, {inner}, {grid}, {n_chains}")


def fma_chain(x: torch.Tensor, *, inner: int = INNER, grid: int = GRID,
              n_chains: int = N_CHAINS, fused: bool = True) -> torch.Tensor:
    """K7 (csrc/microbench.cu fma_chain_kernel): `fma_chain_plain` of x,
    recomputed `grid` times by as many repeats of the CTAs (the TPU grid's
    steps). CPU tensors take the plain version (the grid repeats the same
    values)."""
    _check_chain(x, inner, grid, n_chains)
    if not x.is_cuda:
        return fma_chain_plain(x, inner=inner, n_chains=n_chains, fused=fused)
    out = torch.empty_like(x)
    name = "fma_chain_fused" if fused else "fma_chain_unfused"
    with torch.cuda.device(x.device):
        _launch(name, _library().mb_fma_chain, x.data_ptr(), out.data_ptr(),
                x.numel(), inner, grid, n_chains, int(fused))
    return out


def fma_chain_triton(x: torch.Tensor, *, inner: int = INNER,
                     grid: int = GRID,
                     n_chains: int = N_CHAINS) -> torch.Tensor:
    """The Triton twin of K7's fused variant: the same chains and grid
    through a second code generator (Triton's FP fusion left on, so each
    multiply-add is an FMA), the counterpart of the JAX tool's XLA twin
    `_fma_bench_xla`. CPU tensors take `fma_chain_plain(fused=True)`."""
    _check_chain(x, inner, grid, n_chains)
    if not x.is_cuda:
        return fma_chain_plain(x, inner=inner, n_chains=n_chains, fused=True)
    from rendering_tpu_torch.ops import microbench_triton

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        microbench_triton.launch_fma_chain(x, out, inner=inner, grid=grid,
                                           n_chains=n_chains)
    KERNELS["fma_chain_triton"].launches += 1
    return out


# ---- K8: the grid's per-CTA and per-step cost --------------------------------

def _check_grid(x: torch.Tensor, n_steps: int, what: str) -> None:
    _check("x", x)
    if n_steps < 1:
        raise ValueError(f"{what}: n_steps must be >= 1, got {n_steps}")


def grid_overhead_plain(x: torch.Tensor, n_steps: int) -> torch.Tensor:
    """K8's function: the block copied (every other step does nothing).
    Both forms compute it."""
    return x.clone()


def grid_overhead(x: torch.Tensor, n_steps: int) -> torch.Tensor:
    """K8's first form (csrc/microbench.cu grid_overhead_kernel): one
    launch of n_steps CTAs, CTA 0 copying x. n_steps = 1 is the empty
    grid; it measures the block scheduler's cost per CTA."""
    _check_grid(x, n_steps, "grid_overhead")
    if not x.is_cuda:
        return grid_overhead_plain(x, n_steps)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("grid_overhead", _library().mb_grid_overhead, x.data_ptr(),
                out.data_ptr(), x.numel(), n_steps)
    return out


def grid_overhead_loop(x: torch.Tensor, n_steps: int) -> torch.Tensor:
    """K8 in the TPU probe's form (csrc/microbench.cu
    grid_overhead_loop_kernel): one launch of min(n_steps, SMs) CTAs that
    take the n_steps steps in turn, each step ending at a barrier, the CTA
    holding step 0 copying x; it measures the cost of a step of a loop
    inside the block."""
    _check_grid(x, n_steps, "grid_overhead_loop")
    if not x.is_cuda:
        return grid_overhead_plain(x, n_steps)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("grid_overhead_loop", _library().mb_grid_overhead_loop,
                x.data_ptr(), out.data_ptr(), x.numel(), n_steps)
    return out


# ---- K9: the pair test's product -------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as __float_to_tf32 (cvt.rna.tf32.f32) does: to
    nearest, ties away from zero, on the low 13 mantissa bits; NaN kept."""
    bits = x.view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what the tensor cores read
    of an f32 value that was not rounded by __float_to_tf32 (a control of
    the TF32 limits)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_disagreement(out: torch.Tensor, ref: torch.Tensor,
                      feats: torch.Tensor, coef: torch.Tensor, *,
                      n_steps: int, epilogue: bool) -> tuple[float, float]:
    """How far a default-precision K9 output `out` lies from the plain
    version `ref`, and the limit for it. The TF32 tensor cores sum in an
    order of their own, so without the epilogue: max |diff| / (2 max_s
    sum_k |c f|) (the bound of o = p + 0.5 o over the products' absolute
    sums), limit TF32_SUM_TOL; with it, the share of the columns whose t
    lies outside rtol TF32_T_RTOL (an accept set that flips at a
    boundary), limit TF32_MAX_FLIPS. The limits reject the f32 product
    and inputs truncated to TF32 (chip_smoke.py checks both controls in
    every run; PERF.md gives the readings)."""
    if not epilogue:
        c = to_tf32(coef[:min(n_steps, coef.shape[0]), 0]).abs()
        scale = 2 * (c @ to_tf32(feats).abs()).amax(dim=0)
        return float(((out - ref).abs()[0] / scale).max()), TF32_SUM_TOL
    far = ~torch.isclose(out, ref, rtol=TF32_T_RTOL, atol=0)
    return float(far.float().mean()), TF32_MAX_FLIPS


def _products(coef: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """coef (n, m, k) x feats (k, br), each entry summed in k order in f32
    from the first product (a multiply and an add per term)."""
    out = coef[:, :, 0, None] * feats[0]
    for kk in range(1, coef.shape[2]):
        out = out + coef[:, :, kk, None] * feats[kk]
    return out


def pair_product_plain(feats: torch.Tensor, coef: torch.Tensor,
                       o_init: torch.Tensor, *, tc: int, n_steps: int,
                       precision: str = "highest",
                       epilogue: bool = False) -> torch.Tensor:
    """K9's function (tools/microbench_kernel.py `_mm_kernel` over
    n_steps grid steps), with o starting at o_init (1, br). Step s forms
    P = coef[s % n_tab] @ feats, summed in k order; `default` first
    rounds both inputs to TF32. Without the epilogue o = P[0] + 0.5 o in
    step order; with it o = min(t_min + row * 0, o), t_min the least
    accepted Moller-Trumbore t per column (T_NONE if none) and row its
    lowest row. P depends on s only through s % n_tab, so each table's
    product is formed once."""
    if precision == "default":
        coef, feats = to_tf32(coef), to_tf32(feats)
    n_tab = coef.shape[0]
    used = min(n_steps, n_tab)
    if not epilogue:
        p0 = _products(coef[:used, 0:1], feats)[:, 0]       # (used, br)
        o = o_init[0]
        for s in range(n_steps):
            o = p0[s % n_tab] + o * 0.5
        return o[None]
    br = feats.shape[1]
    per = max(1, (1 << 26) // (4 * tc * br))                # tables a batch
    rows = torch.arange(tc, dtype=torch.int32, device=feats.device)[:, None]
    o = o_init[0]
    for t0 in range(0, used, per):
        p = _products(coef[t0:min(used, t0 + per)], feats)
        det, tdet, udet, vdet = (p[:, i * tc:(i + 1) * tc] for i in range(4))
        ok = det >= 1e-8
        inv = 1.0 / torch.where(ok, det, 1.0)
        u, v, t = udet * inv, vdet * inv, tdet * inv
        ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
        tm = torch.where(ok, t, T_NONE)
        t_min = tm.amin(dim=1)
        row = torch.where(tm == t_min[:, None], rows, 2**30).amin(dim=1)
        o = torch.minimum(o, (t_min + row.float() * 0.0).amin(dim=0))
    return o[None]


def padded_k(k: int) -> int:
    """kp: k rounded up to a multiple of 8, the TF32 wgmma's depth."""
    return (k + 7) // 8 * 8


def _check_pack(coef: torch.Tensor, tc: int) -> None:
    _check("coef", coef)
    if coef.dim() != 3 or coef.shape[1] != 4 * tc:
        raise ValueError(f"pack_tables: coef must be (n_tab, 4 tc, k) with tc "
                         f"= {tc}, got {tuple(coef.shape)}")
    n_tab, _, k = coef.shape
    if n_tab < 1 or tc < WG_ROWS or tc % WG_ROWS or not 1 <= k <= MAX_K:
        raise ValueError(f"pack_tables needs a table, tc a multiple of "
                         f"{WG_ROWS} and 1 <= k <= {MAX_K}; got n_tab={n_tab}, "
                         f"tc={tc}, k={k}")


def packed_rows(tc: int, device=None) -> torch.Tensor:
    """The table row of each packed row: chunks of WG_ROWS rows of each of
    the four tc-row blocks in turn (chunk c holds rows c WG_ROWS ..
    c WG_ROWS + WG_ROWS - 1 of det, tdet, udet and vdet)."""
    q = torch.arange(4 * tc, device=device)
    chunk, w = q // (4 * WG_ROWS), q % (4 * WG_ROWS)
    return (w // WG_ROWS) * tc + chunk * WG_ROWS + w % WG_ROWS


def pack_tables_plain(coef: torch.Tensor, tc: int) -> torch.Tensor:
    """K9's packing pass (csrc/microbench.cu pack_tf32_kernel): each table
    (4 tc, k) rounded to TF32 (`to_tf32`), zero-padded to kp =
    `padded_k(k)`, its rows in `packed_rows` order, and written as wgmma's
    K-major image without swizzle: core matrices of 8 rows x 4 values,
    ordered by row group, then by k / 4. Returns (n_tab, 4 tc * kp)."""
    _check_pack(coef, tc)
    n_tab, rows, k = coef.shape
    kp = padded_k(k)
    padded = torch.zeros((n_tab, rows, kp), dtype=coef.dtype,
                         device=coef.device)
    padded[:, :, :k] = to_tf32(coef)
    t = padded[:, packed_rows(tc, coef.device)]
    t = t.reshape(n_tab, rows // 8, 8, kp // 4, 4).permute(0, 1, 3, 2, 4)
    return t.reshape(n_tab, rows * kp).contiguous()


def pack_tables(coef: torch.Tensor, tc: int) -> torch.Tensor:
    """`pack_tables_plain` by the packing kernel on a card (one launch,
    counted as `pair_pack_tf32`); CPU tensors take the plain version."""
    _check_pack(coef, tc)
    if not coef.is_cuda:
        return pack_tables_plain(coef, tc)
    n_tab, rows, k = coef.shape
    out = torch.empty((n_tab, rows * padded_k(k)), dtype=torch.float32,
                      device=coef.device)
    with torch.cuda.device(coef.device):
        _launch("pair_pack_tf32", _library().mb_pack_tables, coef.data_ptr(),
                out.data_ptr(), n_tab, tc, k)
    return out


def pair_recurrence_plain(scratch: torch.Tensor,
                          o: torch.Tensor) -> torch.Tensor:
    """K9's second pass without the epilogue: o = p_s + 0.5 o over the rows
    p_s of scratch (n_steps, br), in step order, from o (1, br)."""
    v = o[0]
    for p in scratch:
        v = p + v * 0.5
    return v[None]


def pair_recurrence(scratch: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """`pair_recurrence_plain` by csrc/microbench.cu pair_recurrence_kernel
    on a card, in place into o (counted as `pair_recurrence`); CPU tensors
    take the plain version."""
    _check("scratch", scratch)
    if scratch.dim() != 2 or scratch.shape[0] < 1:
        raise ValueError(f"pair_recurrence: scratch must be (n_steps >= 1, "
                         f"br), got {tuple(scratch.shape)}")
    _check("o", o, (1, scratch.shape[1]))
    if scratch.device != o.device:
        raise ValueError("pair_recurrence: tensors on different devices")
    if not o.is_cuda:
        return pair_recurrence_plain(scratch, o)
    with torch.cuda.device(o.device):
        _launch("pair_recurrence", _library().mb_pair_recurrence,
                scratch.data_ptr(), o.data_ptr(), scratch.shape[1],
                scratch.shape[0])
    return o


def pair_product_fn(feats: torch.Tensor, coef: torch.Tensor,
                    o_init: torch.Tensor, *, tc: int, n_steps: int,
                    precision: str = "highest", epilogue: bool = False):
    """Checks K9's inputs once and returns a function of no arguments that
    computes `pair_product` of them: a timed loop calls it without the
    check of o_init's sign, which waits for the card. The tensors must not
    change between the check and the calls."""
    if precision not in PRECISIONS:
        raise ValueError(f"pair_product: precision must be one of "
                         f"{PRECISIONS}, got {precision!r}")
    if feats.dim() != 2 or coef.dim() != 3:
        raise ValueError("pair_product: feats must be (k, br) and coef "
                         "(n_tab, 4 tc, k)")
    k, br = feats.shape
    _check("feats", feats)
    _check("coef", coef, (coef.shape[0], 4 * tc, k))
    _check("o_init", o_init, (1, br))
    if coef.shape[0] < 1 or n_steps < 1 or tc < 1:
        raise ValueError("pair_product: need a table, n_steps >= 1, tc >= 1")
    if not (feats.device == coef.device == o_init.device):
        raise ValueError("pair_product: tensors on different devices")
    if epilogue and bool((torch.signbit(o_init) | torch.isnan(o_init)).any()):
        raise ValueError("pair_product: with the epilogue o_init must be "
                         ">= +0 and not NaN")
    kw = dict(tc=tc, n_steps=n_steps, precision=precision, epilogue=epilogue)
    if not feats.is_cuda:
        return lambda: pair_product_plain(feats, coef, o_init, **kw)
    rows, cols = PAIR_TILES[precision]
    most_steps = (2**31 - 1) // br
    if tc % rows or br % cols or k > MAX_K or n_steps > most_steps:
        raise ValueError(f"pair_product ({precision}) on the card needs tc "
                         f"a multiple of {rows}, br of {cols}, k <= {MAX_K} "
                         f"and n_steps <= {most_steps}; "
                         f"got tc={tc}, br={br}, k={k}, n_steps={n_steps}")
    tf32 = int(precision == "default")
    name = pair_name(precision, epilogue)

    def run() -> torch.Tensor:
        out = o_init.clone()
        scratch = (None if epilogue else
                   torch.empty((n_steps, br), dtype=torch.float32,
                               device=feats.device))
        ptrs = (coef.data_ptr(), feats.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), None)
        sizes = (coef.shape[0], tc, br, k, n_steps, tf32, int(epilogue), 0)
        with torch.cuda.device(feats.device):
            packed = pack_tables(coef, tc) if tf32 else None
            _launch(name, _library().mb_pair_product, *ptrs,
                    None if packed is None else packed.data_ptr(), *sizes)
            if scratch is not None:
                pair_recurrence(scratch, out)
        return out
    return run


def pair_product(feats: torch.Tensor, coef: torch.Tensor,
                 o_init: torch.Tensor, *, tc: int, n_steps: int,
                 precision: str = "highest", epilogue: bool = False
                 ) -> torch.Tensor:
    """K9: `pair_product_plain` on the card (csrc/microbench.cu
    pair_simt_kernel for `highest`; for `default` `pack_tables`, then
    pair_wgmma_kernel), the steps on a persistent grid. feats (k, br),
    coef (n_tab, 4 tc, k), o_init (1, br); with the epilogue o_init
    must be >= +0 and not NaN (the steps combine by an integer atomic min
    on the bits). On the card tc, br and k must fit the form's tiles
    (PAIR_TILES, k <= MAX_K); it raises, never falls back. Without the
    epilogue it ends with `pair_recurrence`. CPU tensors take the plain
    version."""
    return pair_product_fn(feats, coef, o_init, tc=tc, n_steps=n_steps,
                           precision=precision, epilogue=epilogue)()


# The epilogue's SIMT instructions per (row, column) pair and step
# (csrc/microbench.cu kEpilogueOps, derived there from epilogue_row).
EPILOGUE_OPS = 19


def pair_flops(*, tc: int, br: int, k: int, n_steps: int) -> int:
    """The product's operations, the JAX tool's 2 x 4 tc x br x k per step."""
    return 2 * 4 * tc * br * k * n_steps


def pair_epilogue_ops(*, tc: int, br: int, n_steps: int) -> int:
    """The epilogue's SIMT instructions: EPILOGUE_OPS per (row, column)
    pair of every step."""
    return EPILOGUE_OPS * tc * br * n_steps
