"""The integrator's deterministic index accumulation
(`rendering_tpu_torch.ops.accumulate`): its plain version against
`index_add` on the CPU (within 1e-6 relative in float32 on pixel-like
ids, exactly on integer-valued data at every edge case), the CPU
wrapper bit-equal to `index_add`, and the per-object gather whose
backward it carries (`gather_rows`: gradcheck in float64, its forward
and CPU backward bit-equal to plain indexing's). The tests marked
`cuda` run the kernel (csrc/index_accumulate.cu) on a card against the
plain version bit for bit, and repeat frames and train steps of
t01_simple_shapes; they skip without a CUDA device.

This file imports neither JAX nor the JAX package, so its card tests
also run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_accumulate.py
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from rendering_tpu_torch.ops import accumulate as acc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _crossing(q, seed):
    """Runs of 1-3000 equal ids over q lanes in shuffled lane order, so
    sorted they cross chunk boundaries."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3000, q // 1000 + 1)
    ids = np.repeat(np.arange(lengths.size), lengths)[:q]
    return rng.permutation(ids), lengths.size


def _case(name):
    """(ids (Q,) int64, N) of each edge case, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty":
        return np.zeros(0, np.int64), 7
    if name == "ragged":  # Q not a multiple of the chunk
        return rng.integers(0, 50, 3 * acc.THREADS + 77), 50
    if name == "one_index":
        return np.full(5000, 3), 10
    if name == "five_indices":  # the train step's per-object backward
        return rng.integers(0, 5, 131072), 5
    if name == "run_at_last":  # SSAA fill lanes behind the masked pixels
        n = 480_000
        return np.concatenate([rng.integers(0, n, 30_000),
                               np.full(50_000, n - 1)]), n
    if name.startswith("crossing_"):  # one case for each slice length
        q = {"s1": 100_000, "s2": 200_000, "s4": 400_000,
             "s8": 700_000}[name.split("_")[1]]
        return _crossing(q, 1)
    if name == "tiles":  # > CARRY_THREADS chunks, a run over a tile edge
        ids = np.concatenate([rng.integers(0, 50, 600_000),
                              np.full(1_700_000, 50)])
        return rng.permutation(ids), 51
    raise KeyError(name)


CASES = ["empty", "ragged", "one_index", "five_indices", "run_at_last",
         "crossing_s1", "crossing_s2", "crossing_s4", "crossing_s8", "tiles"]


def test_slice_lanes_by_lane_count():
    """Each crossing case takes the slice length it is named for, and
    every slice length leaves at least MIN_CHUNKS chunks once Q can."""
    for name in CASES[5:9]:
        ids, _ = _case(name)
        assert f"s{acc.slice_lanes(ids.size)}" == name.split("_")[1]
    for q in (1, 1000, 131072, 524288, 4 << 20):
        s = acc.slice_lanes(q)
        chunks = -(-q // (acc.THREADS * s))
        assert s == 1 or chunks >= acc.MIN_CHUNKS


@pytest.mark.parametrize("name", CASES)
def test_plain_exact_on_integer_values(name):
    """Integer-valued float64 (and float32, whose sums here stay exact):
    every order of summation gives the same bits, so the plain version
    equals index_add exactly; a lane lost or added would show."""
    ids, n = _case(name)
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(ids)
    for dt in (torch.float64, torch.float32):
        values = torch.from_numpy(rng.integers(-8, 9, (2, ids.size))).to(dt)
        accum = torch.from_numpy(rng.integers(-8, 9, (2, n))).to(dt)
        got = acc.index_accumulate_plain(accum, idx, values)
        assert torch.equal(got, accum.index_add(1, idx, values))


def test_plain_close_to_index_add_f32():
    """float32 on pixel-like ids (runs of 8 lanes on average): within
    1e-6 relative of index_add's lane-order sums."""
    rng = np.random.default_rng(0)
    q, n = 200_000, 25_000
    idx = torch.from_numpy(rng.integers(0, n, q))
    values = torch.from_numpy(rng.uniform(0.5, 1.5, (3, q)).astype(np.float32))
    accum = torch.from_numpy(rng.uniform(0.5, 1.5, (3, n)).astype(np.float32))
    got = acc.index_accumulate_plain(accum, idx, values)
    torch.testing.assert_close(got, accum.index_add(1, idx, values),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("idx_dtype", [torch.int64, torch.int32])
def test_cpu_wrapper_is_index_add(idx_dtype):
    """On CPU tensors the wrapper is index_add, bit for bit, gradients
    too, and no kernel launches."""
    rng = np.random.default_rng(1)
    ids, n = _case("run_at_last")
    idx = torch.from_numpy(ids).to(idx_dtype)
    values = torch.from_numpy(rng.normal(size=(3, ids.size))
                              .astype(np.float32)).requires_grad_(True)
    accum = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    before = acc.KERNELS["index_accumulate"].launches
    got = acc.index_accumulate(accum, idx, values)
    want = accum.index_add(1, idx, values)
    assert torch.equal(got, want)
    w = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    (g_got,) = torch.autograd.grad((got * w).sum(), values)
    (g_want,) = torch.autograd.grad((want * w).sum(), values)
    assert torch.equal(g_got, g_want)
    assert acc.KERNELS["index_accumulate"].launches == before


@pytest.mark.parametrize("shape,transpose", [((5,), False), ((5, 3), True),
                                             ((5, 2, 3), False)])
def test_gather_rows_gradcheck(shape, transpose):
    """The per-object gather's Function in float64: gradcheck, and its
    forward bit-equal to plain indexing."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
    obj = torch.from_numpy(rng.integers(0, shape[0], 40))
    out = acc.gather_rows(table, obj, transpose=transpose)
    assert torch.equal(out, table.T[:, obj] if transpose else table[obj])
    assert torch.autograd.gradcheck(
        lambda t: acc.gather_rows(t, obj, transpose=transpose), (table,))


def test_gather_rows_cpu_backward_in_lane_order():
    """On the CPU the per-object gather's gradient is index_add's sum of
    the gradient's lanes into the rows, lane by lane, and within 1e-5 of
    plain indexing's (sums of 4,000 lanes, which its CPU scatter orders
    otherwise); a table without grad and an integer table are gathered
    as before, outside the Function."""
    rng = np.random.default_rng(3)
    q = 20_000
    obj = torch.from_numpy(rng.integers(0, 5, q))
    for transpose in (False, True):
        shape = (5, 3) if transpose else (5,)
        t0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        gout = torch.from_numpy(rng.normal(
            size=(3, q) if transpose else (q,)).astype(np.float32))
        grads = []
        for fn in (lambda t: acc.gather_rows(t, obj, transpose=transpose),
                   lambda t: t.T[:, obj] if transpose else t[obj]):
            t = t0.clone().requires_grad_(True)
            (g,) = torch.autograd.grad((fn(t) * gout).sum(), t)
            grads.append(g)
        g2 = gout if transpose else gout[None, :]
        lanes = torch.zeros((g2.shape[0], 5)).index_add(1, obj, g2)
        assert torch.equal(grads[0], lanes.T if transpose else lanes[0])
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-4)
    assert acc.gather_rows(t0, obj).grad_fn is None
    mat = torch.tensor([0, 1, 2, 3, 1], dtype=torch.int32)
    assert torch.equal(acc.gather_rows(mat, obj), mat[obj])


# ---- on a card --------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_bit_equal_to_plain(cuda, name):
    """The kernel against the plain version (run on the CPU) on every
    edge case, seeded normal values: bit-equal, one launch a call (none
    for Q = 0)."""
    ids, n = _case(name)
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(ids)
    values = torch.from_numpy(rng.normal(size=(3, ids.size))
                              .astype(np.float32))
    accum = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    before = acc.KERNELS["index_accumulate"].launches
    got = acc.index_accumulate(accum.to(cuda), idx.to(cuda), values.to(cuda))
    torch.cuda.synchronize()
    want = acc.index_accumulate_plain(accum, idx, values)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert acc.KERNELS["index_accumulate"].launches == before + (ids.size > 0)


@pytest.mark.cuda
def test_kernel_repeats_without_host_sync(cuda):
    """Two calls bit-equal; no host sync inside a call (the sync debug
    mode raises on one); the launch count equals the calls made."""
    ids, n = _case("run_at_last")
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(ids).to(cuda)
    values = torch.from_numpy(rng.normal(size=(3, ids.size))
                              .astype(np.float32)).to(cuda)
    accum = torch.zeros((3, n), device=cuda)
    acc.index_accumulate(accum, idx, values)  # builds the library
    torch.cuda.synchronize()
    before = acc.KERNELS["index_accumulate"].launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [acc.index_accumulate(accum, idx, values) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert acc.KERNELS["index_accumulate"].launches == before + 3
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int32), outs[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_gather_rows_backward_on_card(cuda, transpose):
    """The per-object gather's gradient on the card: the kernel's sum of
    the gradient's lanes into the 5 rows, bit-equal to the plain
    version's."""
    rng = np.random.default_rng(6)
    q = 131072
    obj = torch.from_numpy(rng.integers(0, 5, q))
    shape, gshape = ((5, 3), (3, q)) if transpose else ((5,), (q,))
    table = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=gshape).astype(np.float32))
    t = table.to(cuda).requires_grad_(True)
    (g,) = torch.autograd.grad(
        (acc.gather_rows(t, obj.to(cuda), transpose=transpose)
         * gout.to(cuda)).sum(), t)
    g2 = gout if transpose else gout[None, :]
    want = acc.index_accumulate_plain(torch.zeros((g2.shape[0], 5)), obj, g2)
    want = want.T if transpose else want[0]
    assert torch.equal(g.cpu().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_simple_shapes_frame_and_step_repeat_bit_equal(cuda):
    """t01_simple_shapes (all four materials, 11 bounces) at 200x150 on
    the card: a frame with SSAA twice, and a train step of the light's
    intensity and the object colours twice from the same state, each
    bit-equal; both go through the kernel, and the traced step launches
    no `indexing_backward` kernel of PyTorch's."""
    from torch.profiler import ProfilerActivity, profile

    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.models.scene import load_scene
    from rendering_tpu_torch.models.settings import RenderSettings
    from rendering_tpu_torch.render.pipeline import render_scene

    path = os.path.join(REPO, "tests", "scenes", "t01_simple_shapes.scene")
    base = load_scene(path, RenderSettings(), device=cuda)
    st = base.static

    def sized(scene, **kw):
        return dataclasses.replace(scene, static=dataclasses.replace(
            st, settings=st.settings.replace(width=200, height=150, **kw)))

    ssaa = sized(base, enable_ssaa=True)
    launches = acc.KERNELS["index_accumulate"].launches
    with torch.no_grad():
        frames = [render_scene(ssaa)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert acc.KERNELS["index_accumulate"].launches > launches
    assert torch.equal(frames[0].view(torch.int32),
                       frames[1].view(torch.int32))

    scene = sized(base, enable_ssaa=False)
    paths = (("lights", 0, "intensity"), ("obj_color",))
    gen = torch.Generator(device=cuda).manual_seed(0)
    target = torch.rand((3, 150, 200), generator=gen, device=cuda)
    init, step_fn = make_train_step(paths)
    outs = []
    for _ in range(2):
        params = extract_params(scene, paths)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, _, loss = step_fn(params, init(params), scene, target)
            torch.cuda.synchronize()
        outs.append((loss, {k: (v.detach().clone(), v.grad.clone())
                            for k, v in params.items()}))
        names = [e.key for e in prof.key_averages()]
        assert not [k for k in names if "indexing_backward" in k], names
        assert any("chunk_kernel" in k for k in names), names
    (l0, p0), (l1, p1) = outs
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k][0], p1[k][0]), k
        assert torch.equal(p0[k][1], p1[k][1]), k
        assert float(p0[k][1].abs().sum()) > 0, k
