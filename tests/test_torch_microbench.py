"""The hardware-ceiling probes (`rendering_tpu_torch.ops.microbench`, K7-K9)
in their plain versions on the CPU, against the Pallas kernels of the JAX
package's tools (tools/microbench_vpu.py, tools/microbench_kernel.py) run
in interpret mode, and the two probe tools' control flow.

Tolerances:
- K7 (the FMA chains): none. The Pallas kernel in interpret mode (and the
  jitted XLA twin) contracts each multiply-add into an FMA on this CPU,
  and `fma_chain_plain(fused=True)` rounds each once: bit-equal, the
  non-finite values (the chains overflow to inf, then NaN) in the same
  places. The unfused chains equal numpy f32 with two roundings.
- K8 (both forms): a copy, equal.
- K9's packing pass and recurrence: exact (a permutation of TF32-rounded
  values; the same f32 operations in the same order).
- K9 at HIGHEST: XLA's dot sums k in an order (and with contractions) of
  its own, the plain version in k order with two roundings per term. Each
  step's P differs by a few ulps of sum |products|, so the output without
  the epilogue agrees within 1e-6 x (2 max sum |products|), the bound of
  the recurrence o = p + 0.5 o. With the epilogue, t = tdet / det agrees
  within rtol 1e-4 where both accept the same pair; a column whose
  accept set flips at a boundary (u + v near 1, say) may differ: at most
  1 in 64 columns.
The JAX kernels read INNER, N_CHAINS and GRID at trace time; the tests
patch them small. `_mm_kernel` reads its output before writing it, so the
tests alias it to o_init, as the port's explicit input.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_port_util  # noqa: F401  (torch at one thread)
from rendering_tpu_torch.ops import microbench as mb

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jvpu():
    return _tool("microbench_vpu")


@pytest.fixture(scope="module")
def jkernel():
    return _tool("microbench_kernel")


def _same(a, b):
    """Bit equality of f32 arrays, NaN positions included."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))


def _chain_input(kind, shape, seed=0):
    n = int(np.prod(shape))
    if kind == "linspace":
        return np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(shape)
    return (np.random.default_rng(seed).normal(0, 2, shape)
            .astype(np.float32))


# ---- K7 ----------------------------------------------------------------------

@pytest.mark.parametrize("inner,n_chains,kind", [
    (8, 6, "linspace"), (64, 2, "normal"), (512, 6, "linspace"),
    (100, 8, "normal")])
def test_fma_chain_plain_matches_pallas_kernel(jvpu, monkeypatch, inner,
                                               n_chains, kind):
    """fused plain K7 equals `_fma_kernel` in interpret mode on (8, 128)
    blocks over a grid of 2, NaN and inf in the same places; at INNER 512
    the linspace chains overflow."""
    monkeypatch.setattr(jvpu, "INNER", inner)
    monkeypatch.setattr(jvpu, "N_CHAINS", n_chains)
    x = _chain_input(kind, (16, 128))
    spec = pl.BlockSpec((8, 128), lambda i: (i, 0))
    want = pl.pallas_call(
        jvpu._fma_kernel, grid=(2,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        interpret=True)(x)
    got = mb.fma_chain_plain(torch.from_numpy(x), inner=inner,
                             n_chains=n_chains, fused=True)
    assert _same(got.numpy(), want)
    if inner == 512:
        assert np.isinf(np.asarray(want)).sum() > 100
    if kind == "normal":
        assert not np.isfinite(np.asarray(want)).all()


def test_fma_chain_plain_matches_xla_twin(jvpu, monkeypatch):
    """fused plain K7 with inner = INNER x GRID equals `_fma_bench_xla`
    (the JAX tool's second method), traced afresh at patched sizes."""
    monkeypatch.setattr(jvpu, "INNER", 24)
    monkeypatch.setattr(jvpu, "GRID", 3)
    x = _chain_input("normal", (8, 128), seed=3)
    want = jax.jit(jvpu._fma_bench_xla.__wrapped__)(x)
    got = mb.fma_chain_plain(torch.from_numpy(x), inner=72,
                             n_chains=jvpu.N_CHAINS, fused=True)
    assert _same(got.numpy(), want)


def _numpy_chain(x, inner, n_chains):
    """The chain mix in numpy f32, each product and sum rounded."""
    f32 = np.float32
    a = x * f32(1.000001) + f32(0.3)
    b = x * f32(0.999999) - f32(0.3)
    accs = [x + f32(0.01 * c) for c in range(n_chains)]
    for _ in range(inner):
        accs = [acc * a + b for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return out


@pytest.mark.parametrize("inner,kind", [(16, "linspace"), (512, "linspace"),
                                        (50, "normal")])
def test_fma_chain_unfused_matches_numpy(inner, kind):
    x = _chain_input(kind, (8, 128), seed=5)
    with np.errstate(over="ignore", invalid="ignore"):
        want = _numpy_chain(x, inner, 6)
    got = mb.fma_chain_plain(torch.from_numpy(x), inner=inner, n_chains=6,
                             fused=False)
    assert _same(got.numpy(), want)
    fused = mb.fma_chain_plain(torch.from_numpy(x), inner=inner, n_chains=6)
    assert not _same(fused.numpy(), want)  # the two modes differ


def test_fma_emulation_rounds_once():
    """`_fma` equals the exactly rounded p * q + r (Python fractions) on
    values whose float64 sum would round twice, and keeps inf and NaN."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    p = rng.normal(size=4000).astype(np.float32)
    q = rng.normal(size=4000).astype(np.float32)
    r = (-p.astype(np.float64) * q).astype(np.float32)  # cancellation
    r[::2] = rng.normal(size=2000).astype(np.float32) * np.float32(1e-7)
    # p * q + r = 1 + 2^-24 + 2^-60: float64 rounds it to the float32
    # midpoint 1 + 2^-24, which rounds to even (1.0); the FMA gives
    # 1 + 2^-23.
    p[:4] = np.float32(1.0 + 2.0 ** -23)
    q[:4] = np.float32(1.0 - 2.0 ** -24)
    r[:4] = np.float32(2.0 ** -47 * (1.0 + 2.0 ** -13))
    got = mb._fma(*(torch.from_numpy(v).double() for v in (p, q, r))).numpy()
    for i in range(len(p)):
        exact = Fraction(float(p[i])) * Fraction(float(q[i])) + Fraction(
            float(r[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.float32(c).view(np.int32))
                                         & 1))
        assert got[i] == best, i
    assert got[0] == np.float32(1.0 + 2.0 ** -23)
    inf = torch.tensor([np.inf, np.inf, -np.inf], dtype=torch.float64)
    out = mb._fma(inf, torch.tensor([2.0, 0.0, 1.0], dtype=torch.float64),
                  torch.tensor([1.0, 1.0, np.inf], dtype=torch.float64))
    assert out[0] == np.inf and torch.isnan(out[1:]).all()


def test_fma_chain_wrappers_take_plain_on_cpu():
    x = torch.from_numpy(_chain_input("linspace", (8, 128)))
    counts = {k: v.launches for k, v in mb.KERNELS.items()}
    for fused in (True, False):
        assert _same(mb.fma_chain(x, inner=9, grid=4, n_chains=3,
                                  fused=fused).numpy(),
                     mb.fma_chain_plain(x, inner=9, n_chains=3,
                                        fused=fused).numpy())
    assert _same(mb.fma_chain_triton(x, inner=9, grid=4, n_chains=3).numpy(),
                 mb.fma_chain_plain(x, inner=9, n_chains=3).numpy())
    assert counts == {k: v.launches for k, v in mb.KERNELS.items()}
    for bad in (dict(n_chains=0), dict(n_chains=9), dict(grid=0),
                dict(inner=-1)):
        with pytest.raises(ValueError):
            mb.fma_chain(x, **bad)
    with pytest.raises(ValueError, match="float32"):
        mb.fma_chain(x.double())


# ---- K8 ----------------------------------------------------------------------

def test_grid_overhead_plain_matches_pallas():
    """K8's plain version against the JAX tool's body in interpret mode.
    The body is a closure inside `bench_grid_overhead`
    (tools/microbench_kernel.py:40), which cannot be imported, so it is
    copied here."""
    def kernel(counts_ref, x_ref, o_ref):
        s = pl.program_id(0)

        @pl.when(s == 0)
        def _():
            o_ref[...] = x_ref[...]

    br, n_steps = 128, 16
    x = np.random.default_rng(1).normal(size=(8, br)).astype(np.float32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_steps,),
        in_specs=[pl.BlockSpec((8, br), lambda s, c: (0, 0))],
        out_specs=pl.BlockSpec((8, br), lambda s, c: (0, 0)))
    want = pl.pallas_call(kernel, grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((8, br), jnp.float32),
                          interpret=True)(jnp.zeros((1, 1), jnp.int32), x)
    got = mb.grid_overhead(torch.from_numpy(x), n_steps)
    assert _same(got.numpy(), want)
    with pytest.raises(ValueError):
        mb.grid_overhead(torch.from_numpy(x), 0)


@pytest.mark.parametrize("n_steps", [1, 5, 16])
def test_grid_overhead_loop_plain_is_a_copy(n_steps):
    """K8's loop form computes what the TPU probe does: the block copied,
    whatever the step count (the Pallas body is held to the same plain
    version above)."""
    x = torch.from_numpy(np.random.default_rng(n_steps).normal(
        size=(8, 128)).astype(np.float32))
    counts = {k: v.launches for k, v in mb.KERNELS.items()}
    out = mb.grid_overhead_loop(x, n_steps)
    assert _same(out.numpy(), x.numpy())
    assert out.data_ptr() != x.data_ptr()
    assert counts == {k: v.launches for k, v in mb.KERNELS.items()}
    for bad in (0, -3):
        with pytest.raises(ValueError, match="n_steps"):
            mb.grid_overhead_loop(x, bad)
    with pytest.raises(ValueError, match="float32"):
        mb.grid_overhead_loop(x.double(), 4)


# ---- K9 ----------------------------------------------------------------------

def _pair_inputs(tc, br, k, epilogue, seed):
    rng = np.random.default_rng(seed)
    coef = rng.normal(size=(mb.N_TAB, 4 * tc, k)).astype(np.float32)
    feats = rng.normal(size=(k, br)).astype(np.float32)
    o_init = np.full((1, br), mb.T_NONE if epilogue else 0.0, np.float32)
    return coef, feats, o_init


def _jax_pair(jkernel, coef, feats, o_init, *, tc, n_steps, epilogue):
    """`_mm_kernel` at HIGHEST in interpret mode over n_steps grid steps,
    its output aliased to o_init (input 3)."""
    k, br = feats.shape
    body = functools.partial(jkernel._mm_kernel,
                             precision=jax.lax.Precision.HIGHEST,
                             epilogue=epilogue, tc=tc)

    def kernel(counts_ref, x_ref, c_ref, o_init_ref, o_ref):
        body(counts_ref, x_ref, c_ref, o_ref)

    n_tab = coef.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_steps,),
        in_specs=[pl.BlockSpec((k, br), lambda s, c: (0, 0)),
                  pl.BlockSpec((None, 4 * tc, k),
                               lambda s, c: (s % n_tab, 0, 0)),
                  pl.BlockSpec((1, br), lambda s, c: (0, 0))],
        out_specs=pl.BlockSpec((1, br), lambda s, c: (0, 0)))
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((1, br), jnp.float32),
        input_output_aliases={3: 0}, interpret=True,
    )(jnp.zeros((1, 1), jnp.int32), feats, coef, o_init))


@pytest.mark.parametrize("tc,br,k,n_steps", [(8, 128, 13, 70), (16, 256, 13, 9),
                                             (8, 128, 128, 66)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_pair_product_plain_matches_mm_kernel(jkernel, tc, br, k, n_steps,
                                              epilogue):
    coef, feats, o_init = _pair_inputs(tc, br, k, epilogue, seed=tc + k)
    want = _jax_pair(jkernel, coef, feats, o_init, tc=tc, n_steps=n_steps,
                     epilogue=epilogue)[0]
    got = mb.pair_product(torch.from_numpy(feats), torch.from_numpy(coef),
                          torch.from_numpy(o_init), tc=tc, n_steps=n_steps,
                          epilogue=epilogue).numpy()[0]
    assert np.isfinite(want).all() and np.isfinite(got).all()
    if not epilogue:
        used = coef[:min(n_steps, mb.N_TAB), 0]            # (tables, k)
        scale = 2 * (np.abs(used)[:, :, None] * np.abs(feats)[None]).sum(
            axis=1).max(axis=0)
        assert (np.abs(got - want) <= 1e-6 * scale).all()
        return
    accepted = want < mb.T_NONE
    assert accepted.sum() > 0.2 * br    # the epilogue is exercised
    close = np.isclose(got, want, rtol=1e-4, atol=0)
    assert (~close).sum() <= br // 64


def test_to_tf32_rounds_to_nearest_ties_away():
    base = np.float32(1.0).view(np.int32)
    bits = np.array([base, base + 0x0FFF, base + 0x1000, base + 0x1001,
                     base + 0x3000, np.float32(-1.0).view(np.int32) + 0x1000],
                    np.int32)
    want = np.array([base, base, base + 0x2000, base + 0x2000, base + 0x4000,
                     np.float32(-1.0).view(np.int32) + 0x2000], np.int32)
    x = torch.from_numpy(bits.view(np.float32))
    assert np.array_equal(mb.to_tf32(x).numpy().view(np.int32), want)
    special = torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0])
    out = mb.to_tf32(special)
    assert out[0] == np.inf and out[1] == -np.inf and torch.isnan(out[2])
    assert torch.equal(out[3:].view(torch.int32), special[3:].view(torch.int32))


def test_pair_product_default_rounds_inputs_to_tf32():
    """`default` is the k-order product of the TF32-rounded inputs, which
    lies within TF32's precision of the f32 product."""
    tc, br, k = 8, 128, 13
    coef, feats, o_init = (torch.from_numpy(a) for a in _pair_inputs(
        tc, br, k, False, seed=2))
    kw = dict(tc=tc, n_steps=3)
    got = mb.pair_product(feats, coef, o_init, precision="default", **kw)
    want = mb.pair_product(mb.to_tf32(feats), mb.to_tf32(coef), o_init,
                           precision="highest", **kw)
    assert torch.equal(got, want)
    f32 = mb.pair_product(feats, coef, o_init, **kw)
    assert not torch.equal(got, f32)
    assert torch.allclose(got, f32, rtol=0, atol=2e-3 * float(
        (coef.abs()[:3, 0] @ feats.abs()).max()))


def test_pair_product_checks_its_inputs():
    tc, br, k = 8, 128, 13
    coef, feats, o_init = (torch.from_numpy(a) for a in _pair_inputs(
        tc, br, k, True, seed=4))
    with pytest.raises(ValueError, match="o_init"):
        mb.pair_product(feats, coef, -o_init, tc=tc, n_steps=2, epilogue=True)
    with pytest.raises(ValueError, match="o_init"):
        mb.pair_product(feats, coef, torch.full_like(o_init, float("nan")),
                        tc=tc, n_steps=2, epilogue=True)
    with pytest.raises(ValueError, match="shape"):
        mb.pair_product(feats, coef, o_init, tc=tc + 1, n_steps=2)
    with pytest.raises(ValueError, match="precision"):
        mb.pair_product(feats, coef, o_init, tc=tc, n_steps=2,
                        precision="high")
    # Without the epilogue any o_init is taken, as the TPU kernel's.
    mb.pair_product(feats, coef, -o_init, tc=tc, n_steps=2)


def _image_offset(q, kk, kp):
    """csrc/microbench.cu's packed image: core matrices of 8 rows x 4
    values, by row group, then k / 4."""
    return (((q // 8) * (kp // 4) + kk // 4) * 8 + q % 8) * 4 + kk % 4


@pytest.mark.parametrize("tc,k", [(32, 13), (64, 40), (32, 128), (96, 1)])
def test_pack_tables_plain_is_tf32_of_padded_tables(tc, k):
    """The packing pass's plain version holds to_tf32 of the zero-padded
    tables, each value where the wgmma kernel reads it: packed row q is
    table row (q % 128 // 32) tc + (q // 128) 32 + q % 32 (chunks of 32
    rows of det, tdet, udet and vdet in turn), at the image offset."""
    rng = np.random.default_rng(tc + k)
    coef = rng.normal(size=(3, 4 * tc, k)).astype(np.float32)
    got = mb.pack_tables_plain(torch.from_numpy(coef), tc).numpy()
    kp = mb.padded_k(k)
    assert kp % 8 == 0 and k <= kp < k + 8
    assert got.shape == (3, 4 * tc * kp)
    want = np.zeros((3, 4 * tc, kp), np.float32)
    want[:, :, :k] = mb.to_tf32(torch.from_numpy(coef)).numpy()
    for q in range(4 * tc):
        row = (q % 128 // 32) * tc + (q // 128) * 32 + q % 32
        for kk in range(kp):
            off = _image_offset(q, kk, kp)
            assert _same(got[:, off], want[:, row, kk]), (q, kk)
    assert set(np.unique(got.view(np.int32) & 0x1FFF)) == {0}   # TF32
    assert mb.packed_rows(tc).tolist() == sorted(
        range(4 * tc), key=lambda r: ((r % tc) // 32, r // tc, r % 32))


def test_pack_tables_takes_plain_on_cpu_and_checks_its_input():
    coef = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 4 * 32, 13)).astype(np.float32))
    counts = {k: v.launches for k, v in mb.KERNELS.items()}
    assert torch.equal(mb.pack_tables(coef, 32),
                       mb.pack_tables_plain(coef, 32))
    assert counts == {k: v.launches for k, v in mb.KERNELS.items()}
    for bad_tc in (16, 48):       # no multiple of WG_ROWS; or of 4 tc rows
        bad = torch.zeros((2, 4 * bad_tc, 13))
        with pytest.raises(ValueError, match="multiple|tc"):
            mb.pack_tables(bad, bad_tc)
    with pytest.raises(ValueError, match="tc = 64"):
        mb.pack_tables(coef, 64)
    with pytest.raises(ValueError, match="k <="):
        mb.pack_tables(torch.zeros((1, 128, mb.MAX_K + 1)), 32)
    with pytest.raises(ValueError, match="float32"):
        mb.pack_tables(coef.double(), 32)


@pytest.mark.parametrize("n_steps", [1, 17, 70])
def test_pair_recurrence_plain_is_the_step_order_recurrence(n_steps):
    """K9's second pass (o = p_s + 0.5 o in step order) equals numpy f32
    with each product and sum rounded, and `_mm_kernel`'s own recurrence
    through `pair_product_plain` (its P[0] rows as scratch); the wrapper
    takes it on the CPU, launches nothing and checks its input."""
    rng = np.random.default_rng(n_steps)
    scratch = rng.normal(size=(n_steps, 128)).astype(np.float32)
    o = rng.normal(size=(1, 128)).astype(np.float32)
    want = o[0].copy()
    for p in scratch:
        want = p + want * np.float32(0.5)
    counts = {k: v.launches for k, v in mb.KERNELS.items()}
    got = mb.pair_recurrence(torch.from_numpy(scratch), torch.from_numpy(o))
    assert _same(got.numpy()[0], want)
    assert counts == {k: v.launches for k, v in mb.KERNELS.items()}
    tc, k = 8, 13
    coef, feats, o_init = _pair_inputs(tc, 128, k, False, seed=n_steps)
    rows = mb._products(torch.from_numpy(coef[:, 0:1]),
                        torch.from_numpy(feats))[:, 0]
    steps = rows[torch.arange(n_steps) % mb.N_TAB]
    assert torch.equal(
        mb.pair_recurrence_plain(steps, torch.from_numpy(o_init)),
        mb.pair_product_plain(torch.from_numpy(feats), torch.from_numpy(coef),
                              torch.from_numpy(o_init), tc=tc,
                              n_steps=n_steps))
    with pytest.raises(ValueError, match="shape"):
        mb.pair_recurrence(torch.from_numpy(scratch), torch.zeros((1, 64)))
    with pytest.raises(ValueError, match="n_steps"):
        mb.pair_recurrence(torch.zeros((0, 128)), torch.zeros((1, 128)))


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_pair_product_takes_plain_on_cpu(precision, epilogue):
    """K9 computes `pair_product_plain`: on CPU tensors the wrapper returns
    it and launches nothing; an unknown precision raises; its launch count
    is one of `KERNELS`."""
    tc, br, k = 8, 128, 13
    coef, feats, o_init = (torch.from_numpy(a) for a in _pair_inputs(
        tc, br, k, epilogue, seed=6))
    kw = dict(tc=tc, n_steps=5, precision=precision, epilogue=epilogue)
    counts = {k: v.launches for k, v in mb.KERNELS.items()}
    got = mb.pair_product(feats, coef, o_init, **kw)
    assert torch.equal(got, mb.pair_product_plain(feats, coef, o_init, **kw))
    assert counts == {k: v.launches for k, v in mb.KERNELS.items()}
    with pytest.raises(ValueError, match="precision"):
        mb.pair_product(feats, coef, o_init, **dict(kw, precision="tf32"))
    assert mb.pair_name(precision, epilogue) in mb.KERNELS


def test_pair_tiles_and_epilogue_ops_match_the_source():
    """The wrapper's tiles and epilogue count are csrc/microbench.cu's own
    constants (the card raises for tiles it does not take)."""
    import re

    with open(mb.SOURCE) as fh:
        src = fh.read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    ops = const("kEpilogueOps")
    assert re.fullmatch(r"[\d +]+", ops) and sum(
        int(v) for v in ops.split("+")) == mb.EPILOGUE_OPS
    assert mb.pair_epilogue_ops(tc=256, br=1024, n_steps=2) == (
        mb.EPILOGUE_OPS * 256 * 1024 * 2)
    assert int(const("kWgN")) == mb.WG_ROWS
    assert mb.PAIR_TILES == {
        "highest": (int(const("kSimtChunk")), int(const("kSimtCols"))),
        "default": (int(const("kWgN")),
                    int(const("kWgMaxGroups")) * int(const("kWgM")))}


# ---- formulas and the tools --------------------------------------------------

@pytest.fixture(scope="module")
def tvpu():
    return _tool("microbench_vpu_torch")


@pytest.fixture(scope="module")
def tkernel():
    return _tool("microbench_kernel_torch")


def _clock(dt):
    """A stand-in `time` module whose perf_counter advances dt a call."""
    t = [0.0]

    def perf_counter():
        t[0] += dt
        return t[0]
    return types.SimpleNamespace(perf_counter=perf_counter)


def test_formulas_equal_the_jax_tools(jvpu, jkernel, tvpu, tkernel,
                                      monkeypatch, capsys):
    """The operation and byte counts of the port's tools equal the JAX
    tools' own, read back through their rates with a clock that ticks 1 s
    (their kernels stubbed: they only run on a TPU)."""
    sizes = dict(ROWS=8, LANES=128, INNER=5, GRID=3, N_CHAINS=4)
    for name, v in sizes.items():
        monkeypatch.setattr(jvpu, name, v)
    monkeypatch.setattr(jvpu, "_fma_bench", lambda x: x)
    monkeypatch.setattr(jvpu, "time", _clock(1.0))
    # vpu_flops times reps launches between two clock reads: dt = 1 / reps.
    assert jvpu.vpu_flops(reps=1) == tvpu.fma_ops(
        rows=8, lanes=128, inner=5, grid=3, n_chains=4)
    assert jvpu.hbm_bandwidth(reps=1, mb=1) == tvpu.hbm_bytes(
        (1 << 20) // 4)
    for tc, br, k in ((256, 1024, 13), (128, 512, 128)):
        n_steps = 16
        flops = mb.pair_flops(tc=tc, br=br, k=k, n_steps=n_steps)
        monkeypatch.setattr(jkernel, "timeit",
                            lambda fn, *a, dt=flops / 1e13, **kw: dt)
        jkernel.bench_matmul(tc=tc, br=br, k=k, n_steps=n_steps)
        assert "(10.0 TFLOP/s nominal)" in capsys.readouterr().out
    assert tkernel.grid_bytes(1024) == 2 * 8 * 1024 * 4


@pytest.mark.parametrize("tool", ["microbench_vpu_torch",
                                  "microbench_kernel_torch"])
def test_tool_main_raises_without_card(tool, monkeypatch):
    mod = _tool(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


def test_tools_drive_their_probes_on_cpu(tvpu, tkernel):
    """The measuring functions run at tiny shapes on the CPU (the plain
    versions, timed by the host clock) and report no device rate."""
    raw = tvpu.measure("cpu", rows=8, lanes=128, inner=3, grid=2,
                       n_chains=2, hbm_mb=1, reps=1)
    assert set(raw["fma"]) == set(tvpu.ROUTES)
    assert raw["fma"]["fused"]["ops"] == 2 * 2 * 8 * 128 * 3 * 2
    with pytest.raises(ValueError, match="no device rate"):
        tvpu.rates(raw, "cpu")
    raw = tkernel.measure("cpu", grid_steps=(1, 8), br=128,
                          configs=((8, 128, 13, "highest", False),
                                   (16, 128, 13, "default", True)),
                          n_steps=3, reps=1)
    assert set(raw) == {"grid", "grid_loop", "launch", "pair"}
    assert [r["n_steps"] for r in raw["grid"]] == [1, 8]
    assert [r["us_per_step"] > 0 for r in raw["pair"]] == [True, True]
    with pytest.raises(ValueError, match="no device time"):
        tkernel.summary(raw, "cpu")
    assert len(tkernel.CONFIGS) == 15
    assert tkernel.CONFIGS[:2] == ((256, 1024, 13, "highest", False),
                                   (256, 1024, 13, "default", False))


def test_kernel_tool_reports_both_forms_and_their_bounds(tkernel):
    """microbench_kernel_torch.py measures K8's two forms, the launch probe
    and K9 in its one form; its bounds add the epilogue's SIMT instructions to
    an f32 product and take the larger beside a TF32 one; its expected
    launch counts follow `measure`'s calls."""
    configs = ((8, 128, 13, "highest", True), (16, 256, 13, "default", False))
    raw = tkernel.measure("cpu", grid_steps=(1, 4), br=128, configs=configs,
                          n_steps=2, reps=1)
    assert [r["form"] for r in raw["grid_loop"]] == ["loop", "loop"]
    assert [(r["precision"], r["epilogue"]) for r in raw["pair"]] == [
        ("highest", True), ("default", False)]
    assert set(raw) == {"grid", "grid_loop", "launch", "pair"}
    assert {"empty_ctas_ms", "clone_ms", "host_us_copy_ctas"} <= set(
        raw["launch"])
    kw = dict(tc=256, br=1024, k=13, n_steps=2048)
    hi = tkernel.pair_bounds(precision="highest", epilogue=True, **kw)
    flops = mb.pair_flops(**kw)
    epi = mb.pair_epilogue_ops(tc=256, br=1024, n_steps=2048)
    assert hi["ops_ms"] == pytest.approx(
        (flops / 67e12 + epi / 33.5e12) * 1e3)
    assert hi["nofma_ms"] == pytest.approx((flops + epi) / 33.5e12 * 1e3)
    tf = tkernel.pair_bounds(precision="default", epilogue=True, **kw)
    assert tf["ops_ms"] == pytest.approx(max(flops / 495e12,
                                             epi / 33.5e12) * 1e3)
    assert tf["bound_by"] == "operations" and tf["nofma_ms"] is None
    plain = tkernel.pair_bounds(precision="default", epilogue=False, **kw)
    assert plain["epilogue_ops"] == 0
    want = tkernel.expected_launches(grid_steps=(1, 4), configs=configs,
                                     reps=1, host_calls=5)
    assert want == {"grid_overhead": 4 * 2 + 5, "grid_overhead_loop": 4 * 2,
                    "pair_product_highest_epilogue": 2,
                    "pair_product_default": 2,
                    "pair_pack_tf32": 2, "pair_recurrence": 2}


def test_bounds_take_the_ports_rates(tkernel):
    """chip_smoke.py and microbench_kernel_torch.py state their bounds at
    the port's one definition of the card's rates (ops/microbench.py),
    and neither defines its own."""
    import ast

    repo = os.path.dirname(TOOLS)
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rates = ("F32_FLOPS_RATE", "F32_OPS_RATE", "HBM_RATE")
    assert mb.F32_OPS_RATE == 67e12 / 2 and mb.HBM_RATE == 3.35e12
    for mod in (smoke, tkernel):
        assert all(getattr(mod, r) is getattr(mb, r) for r in rates)
        tree = ast.parse(open(mod.__file__).read())
        assigned = {t.id for node in ast.walk(tree)
                    if isinstance(node, ast.Assign) for t in node.targets
                    if isinstance(t, ast.Name)}
        assert not assigned & set(rates), mod.__file__
