"""The port's ray sharding (`rendering_tpu_torch.parallel`) on the CPU:
ranks are spawned processes in a gloo group (`torch_dist_util`), and each
result is held against the port's unsharded render or gradient computed
here, and against the JAX package on its 8 virtual CPU devices.

* Layout: `_round_robin_layout` and `unpermute_slots` bit-equal to JAX's.
* Frames at W = 2 and W = 3 ranks (an odd count, as JAX's
  test_sharded_odd_device_count): t01_simple_shapes at 96x64 with SSAA,
  the tiny scene (a transparent sphere, the queue-headroom redo on a
  rank) and the 16-mesh scene, within atol 2e-6 (tests/test_parallel.py's
  limit) and u8-equal to the unsharded `render`; the counters summed over
  the ranks equal the unsharded ones; t01 within test_golden.py's limits
  of JAX's `render_sharded` on as many devices.
* Gradients of the light intensity, the object colours and vertices or
  sphere centres: `make_train_step(mesh=)` and `make_sharded_grad_fn`
  under both schedules against the unsharded port at rtol 1e-4, atol
  1e-4 max|g| (not W times it); the schedules against each other at rtol
  1e-6; the parameters equal bit for bit across the ranks after two
  steps; a sharded step from the same state again bit-equal.
* Strips, animation and the CLI on two ranks; the multihost helpers in
  one process; a rank that leaves its group fails the run, quickly.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from rendering_tpu.models.scene import load_scene as j_load_scene
from rendering_tpu.models.settings import RenderSettings as JSettings
from rendering_tpu.parallel.shard import _round_robin_layout as j_layout
from rendering_tpu.parallel.shard import make_ray_mesh as j_make_ray_mesh
from rendering_tpu.parallel.shard import render_sharded as j_render_sharded
from rendering_tpu.parallel.shard import unpermute_slots as j_unpermute
from rendering_tpu_torch.diff.inverse import (
    apply_params,
    extract_params,
    make_train_step,
)
from rendering_tpu_torch.parallel import multihost
from rendering_tpu_torch.parallel.shard import (
    _round_robin_layout,
    unpermute_slots,
)
from rendering_tpu_torch.render.animation import set_camera
from rendering_tpu_torch.render.pipeline import render, render_scene
from rendering_tpu_torch.render.raygen import tile_dims
from rendering_tpu_torch.utils.bmp import quantize_reference
from test_golden import DEFAULT_TOL, neighborhood_violations
from torch_port_util import golden_fractions
import torch_dist_util as du

FRAME_ATOL = 2e-6  # tests/test_parallel.py
GRAD_RTOL = 1e-4
FRAME_CASES = {
    "t01": {},
    "tiny": {},
    "multimesh": {"enable_ssaa": True},
    # SSAA off, counters on: each rank's 512-ray kernel tiles are the
    # unsharded pass's, so every counter sums to the unsharded value.
    "multimesh_stats": {"collect_statistics": True},
}


def _scene(case):
    return du.make_scene(case.split("_")[0], **FRAME_CASES[case])


# ---- layout --------------------------------------------------------------


LAYOUTS = [(64 * 48, 1, (64, 48)), (64 * 48, 3, (64, 48)),
           (123 * 45, 4, (123, 45)), (64 * 56, 8, (64, 56)),
           (70 * 46, 3, (70, 46)), (96 * 64, 2, (96, 64)),
           (40000, 3, None), (1000, 6, None), (1920 * 8, 2, (1920, 8))]


@pytest.mark.parametrize("r, ndev, wh", LAYOUTS)
def test_round_robin_layout_bit_equal_to_jax(r, ndev, wh):
    rp, perm = _round_robin_layout(r, ndev, wh)
    j_rp, j_perm = j_layout(r, ndev, wh)
    assert rp == j_rp
    np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))


@pytest.mark.parametrize("r, ndev, wh", [c for c in LAYOUTS if c[2]])
def test_unpermute_slots_matches_scatter(r, ndev, wh):
    """The scatter-free inversion equals the permutation scatter, and
    JAX's inversion, on divisible and padded layouts."""
    w, h = wh
    rp, perm = _round_robin_layout(r, ndev, wh)
    vals = torch.arange(3 * rp, dtype=torch.float32).reshape(3, rp)
    ref = np.zeros((3, rp), np.float32)
    ref[:, perm.numpy()] = vals.numpy()
    got = unpermute_slots(vals, r, w, h, ndev).numpy()
    np.testing.assert_array_equal(got, ref[:, :r])
    np.testing.assert_array_equal(
        got, np.asarray(j_unpermute(jax.numpy.asarray(vals.numpy()), r, w,
                                    h, ndev)))


def test_round_robin_slots_are_screen_coherent():
    """Each 512-slot run covers a compact screen region, not a scanline
    (the layout cliff of rendering_tpu/parallel/shard.py:80-91)."""
    w, h, ndev = 1920, 1080, 8
    rp, perm = _round_robin_layout(w * h, ndev, (w, h))
    perm = perm.numpy()
    tw, th = tile_dims(w, h)
    n_rects = -(-512 // (tw * th)) + 1
    for start in (0, 512, rp // 2, rp - 1024):
        run = perm[start:start + 512]
        run = run[run < w * h]
        x, y = run % w, run // w
        area = (x.max() - x.min() + 1) * (y.max() - y.min() + 1)
        assert area <= (n_rects + 1) * tw * th, (start, area)
        assert (x.max() - x.min() + 1) <= (n_rects + 1) * tw, start


# ---- frames ---------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def ray_frames(request, tmp_path_factory):
    world = request.param
    cases = [(c.split("_")[0], FRAME_CASES[c]) for c in FRAME_CASES]
    t0 = time.perf_counter()
    res = du.run_ranks(du.frames_worker, world,
                       tmp_path_factory.mktemp("frames"), cases)
    print(f"{world} ranks: {time.perf_counter() - t0:.1f} s")
    return world, {c: [r[i] for r in res] for i, c in enumerate(FRAME_CASES)}


@pytest.mark.parametrize("case", ["t01", "tiny", "multimesh"])
def test_sharded_frame_matches_unsharded(ray_frames, case):
    world, runs = ray_frames
    scene = _scene(case)
    f1, aux1 = render(scene)
    u1, _ = render(scene, out_u8=True)
    for f, u8, stats, masked, _again in runs[case]:
        np.testing.assert_allclose(f, f1, atol=FRAME_ATOL, rtol=0,
                                   err_msg=f"W={world} {case}")
        np.testing.assert_array_equal(u8, u1)
        assert masked == aux1["ssaa_masked"]
        assert stats["paths_dropped"] == 0
    # Every rank holds the same frame.
    for f, *_ in runs[case][1:]:
        np.testing.assert_array_equal(f, runs[case][0][0])


@pytest.mark.parametrize("case", ["t01", "tiny", "multimesh"])
def test_sharded_render_bit_deterministic(ray_frames, case):
    """A sharded render again gives the same bits (gathers, the SSAA
    all-reduce and the scatter orders included; tests/
    test_determinism.py's check of the JAX package)."""
    _world, runs = ray_frames
    for f, _u8, _stats, _m, again in runs[case]:
        np.testing.assert_array_equal(again, f)


@pytest.mark.parametrize("case", ["t01", "multimesh_stats"])
def test_sharded_stats_equal_unsharded(ray_frames, case):
    """The counters summed over the ranks: rays and drops on t01 (SSAA,
    capacity divisible by W), every counter (K3's too) on the 16-mesh
    scene without SSAA."""
    _world, runs = ray_frames
    _f, aux1 = render(_scene(case))
    want = {k: float(v) for k, v in aux1["stats"].items()}
    if case == "multimesh_stats":
        assert want["ray_tri_tests"] > 0 and want["accel_struct_tests"] > 0
    for _f, _u8, stats, _m, _again in runs[case]:
        assert stats == want


def test_sharded_t01_within_golden_limits_of_jax(ray_frames):
    """t01 at 96x64: the port's sharded u8 frame against JAX's
    render_sharded on as many of the virtual devices."""
    world, runs = ray_frames
    js = j_load_scene(du.T01, JSettings(ssaa_capacity_fraction=1.0))
    js = du.shrink(js, 96, 64)
    j_frame, _ = j_render_sharded(js, j_make_ray_mesh(jax.devices()[:world]))
    ref = quantize_reference(np.asarray(j_frame))
    ours = runs["t01"][0][1]
    f1, f8 = golden_fractions(ours, ref)
    viol = neighborhood_violations(ours, ref)[1:-1, 1:-1].mean()
    assert (f1 <= DEFAULT_TOL[0] and f8 <= DEFAULT_TOL[1]
            and viol <= DEFAULT_TOL[2]), (f1, f8, viol)


# ---- gradients --------------------------------------------------------------


def _grad_run(name, world, tmp):
    """The ranks' results of `du.grads_worker` on GRAD_CASES[name], the
    unsharded train step's first step, and the unsharded gradient of
    make_sharded_grad_fn's loss (the rendered pixels only)."""
    res = du.run_ranks(du.grads_worker, world, tmp, name)
    kw, paths = du.GRAD_CASES[name]
    scene = du.make_scene(name, **kw)
    target = torch.from_numpy(du.grad_target(scene))
    init, step = make_train_step(paths)
    ref = du.train_steps(step, init, scene, paths, target, 1)
    params = extract_params(scene, paths)
    frame = render_scene(apply_params(scene, params, paths))[0]
    loss = torch.mean((frame[:, :-1, :-1] - target[:, :-1, :-1]) ** 2)
    loss.backward()
    fn_ref = (loss.item(), {k: p.grad.numpy() for k, p in params.items()})
    return name, world, res, ref, fn_ref


@pytest.fixture(scope="module")
def mm_grads(tmp_path_factory):
    """The 16-mesh scene without SSAA on two ranks."""
    return _grad_run("multimesh", 2, tmp_path_factory.mktemp("grads"))


@pytest.fixture(scope="module")
def t01_grads(tmp_path_factory):
    """t01 (bouncing, a transparent sphere) with SSAA on three ranks."""
    return _grad_run("t01", 3, tmp_path_factory.mktemp("grads"))


@pytest.fixture(params=["mm_grads", "t01_grads"])
def grad_runs(request):
    return request.getfixturevalue(request.param)


def _assert_grads(got: dict, want: dict, what: str):
    for k, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, f"{what}: {k} has no gradient to compare"
        np.testing.assert_allclose(got[k], g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale,
                                   err_msg=f"{what}: {k}")


def test_train_step_grads_match_unsharded(grad_runs):
    name, world, res, (g_ref, l_ref, _p), _fn = grad_runs
    for rank, r in enumerate(res):
        grads, losses, _params = r["train"]
        assert losses[0] == pytest.approx(l_ref[0], rel=1e-6)
        _assert_grads(grads[0], g_ref[0], f"{name} W={world} rank {rank}")


def test_train_step_params_equal_across_ranks(grad_runs):
    """After two Adam steps every rank holds the same bits, and so do its
    gradients of both steps."""
    _name, _world, res, *_ = grad_runs
    grads0, _l, params0 = res[0]["train"]
    for r in res[1:]:
        grads, _l, params = r["train"]
        for k in params0:
            np.testing.assert_array_equal(params[k], params0[k])
            for g, g0 in zip(grads, grads0):
                np.testing.assert_array_equal(g[k], g0[k])


def test_repeat_sharded_step_bit_equal(grad_runs):
    _name, _world, res, *_ = grad_runs
    for r in res:
        first, again = r["train"], r["train_again"]
        assert again[1][0] == first[1][0]
        for k in first[0][0]:
            np.testing.assert_array_equal(again[0][0][k], first[0][0][k])


@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_grad_fn_matches_unsharded(mm_grads, overlap):
    """make_sharded_grad_fn (the primary pass, no SSAA) under each
    schedule."""
    _name, _world, res, _ref, (l_ref, g_ref) = mm_grads
    for rank, r in enumerate(res):
        loss, grads = r[f"grad_fn_{overlap}"]
        assert loss == pytest.approx(l_ref, rel=1e-6)
        _assert_grads(grads, g_ref, f"grad fn overlap={overlap} rank {rank}")


def test_grad_schedules_agree(mm_grads):
    for r in mm_grads[2]:
        (l_o, g_o), (l_b, g_b) = r["grad_fn_True"], r["grad_fn_False"]
        assert l_o == l_b
        for k in g_o:
            np.testing.assert_allclose(g_o[k], g_b[k], rtol=1e-6, atol=0)


# ---- strips, animation, CLI ------------------------------------------------


@pytest.fixture(scope="module")
def strip_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("strips")
    return du.run_ranks(du.strips_worker, 2, tmp, str(tmp / "ck.npz"),
                        "rays", ("t01", {"width": 64, "height": 48}))


def test_sharded_progress_equals_oneshot(strip_run):
    for r in strip_run:
        np.testing.assert_allclose(r["progress"], r["oneshot"], **du.STRIP_TOL)
        assert r["stats"]["paths_dropped"] == 0
    np.testing.assert_array_equal(strip_run[0]["progress"],
                                  strip_run[1]["progress"])


def test_sharded_progress_prints_on_rank0_only(strip_run):
    assert strip_run[0]["prints"] == ["33%", "67%", "100%"]
    assert strip_run[1]["prints"] == []


def test_sharded_resumable_resumes(strip_run):
    """render_resumable(mesh=) equals the progress frame; after rank 0
    cleared the last strip of the checkpoint, every rank renders only
    that strip and the frame comes out bit-equal."""
    for r in strip_run:
        np.testing.assert_array_equal(r["resumed_from_scratch"],
                                      r["progress"])
        np.testing.assert_array_equal(r["resumed"], r["resumed_from_scratch"])
        assert r["strips"] == [32]


@pytest.fixture(scope="module")
def anim_run(tmp_path_factory):
    return du.run_ranks(du.animation_worker, 2,
                        tmp_path_factory.mktemp("anim"))


@pytest.mark.parametrize("form", ["frames", "pipelined"])
def test_render_frames_mesh_matches_single(anim_run, form):
    scene = du.make_scene("tiny")
    for r in anim_run:
        assert len(r[form]) == len(r["cams"]) == 2
        for (pos, rot), f in zip(r["cams"], r[form]):
            want, _ = render(set_camera(scene, pos, rot_deg=rot))
            np.testing.assert_allclose(f, want, atol=FRAME_ATOL, rtol=0)
        for f, g in zip(r[form], r["frames"]):
            np.testing.assert_array_equal(f, g)


@pytest.mark.parametrize("which", ["t01", "mesh_progress"])
def test_cli_two_ranks_bmp_byte_equal(tmp_path, monkeypatch, which):
    """cli.main in a two-rank group (render_sharded for t01, the sharded
    strips for a scene file with outputProgress=1) writes the one-process
    BMP byte for byte; rank 1 prints nothing."""
    monkeypatch.setenv("RTPU_NATIVE", "0")
    monkeypatch.chdir(tmp_path)
    name = du.T01 if which == "t01" else du.write_mesh_scene(tmp_path)
    one, two, res = du.run_cli_both(tmp_path, name)
    assert one == two
    assert [rc for rc, _ in res] == [0, 0]
    assert res[1][1] == ""


@pytest.mark.parametrize("cards,extra,env,spawns", [
    (2, [], {}, True),
    (2, ["--no-shard"], {}, False),
    (1, [], {}, False),
    (2, [], {"WORLD_SIZE": "2"}, False),
])
def test_cli_entry_spawns_only_when_alone_with_cards(monkeypatch, cards,
                                                     extra, env, spawns):
    """`python -m rendering_tpu_torch` (cli.entry) starts a rank per card
    only when more than one card is visible, no launcher set WORLD_SIZE
    and --no-shard is absent; cli.main itself never spawns."""
    from rendering_tpu_torch import cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    calls = []
    monkeypatch.setattr(cli, "_spawn_ranks",
                        lambda argv, n, device: calls.append(("spawn", n)))
    monkeypatch.setattr(cli, "main",
                        lambda argv, device: calls.append(("main", device)))
    cli.entry(["a.scene", *extra], device="cpu")
    assert calls == ([("spawn", cards)] if spawns else [("main", "cpu")])


def test_cli_entry_two_ranks_bmp_byte_equal(tmp_path, monkeypatch):
    """cli.entry with two cards visible spawns two ranks (the launcher's
    environment on a localhost port), which join one gloo group and
    write the one-process t01 BMP byte for byte."""
    from rendering_tpu_torch import cli

    monkeypatch.setenv("RTPU_NATIVE", "0")
    monkeypatch.chdir(tmp_path)
    assert cli.main([du.T01, "--output", "one.bmp"], device="cpu") == 0
    rc, out = du.run_cli_entry(tmp_path, [du.T01, "--output", "two.bmp"],
                               cards=2)
    assert rc == 0, out
    assert "rendering on 2 ranks" in out
    assert all(f"rank {r} of 2: torch.distributed backend gloo" in out
               for r in (0, 1))
    assert (tmp_path / "one.bmp").read_bytes() == \
        (tmp_path / "two.bmp").read_bytes()


# ---- multihost ----------------------------------------------------------


_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def test_multihost_single_process(monkeypatch):
    """Without a launcher: no group (False), the topology of one
    process, one-rank meshes, and the scaling record."""
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    topo = multihost.process_topology()
    assert (topo["process_index"], topo["process_count"],
            topo["global_devices"]) == (0, 1, 1)
    assert topo["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert multihost.make_global_ray_mesh(device="cpu").rays.size == 1
    assert multihost.make_host_ray_mesh(device="cpu").rays.size == 1
    rep = multihost.scaling_report(1e6, 7.2e6, 8)
    assert abs(rep["efficiency"] - 0.9) < 1e-6 and rep["ideal"] == 8e6


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"},
                                 {"MASTER_ADDR": "localhost",
                                  "MASTER_PORT": "1", "RANK": "0"}])
def test_multihost_partial_env_raises(monkeypatch, env):
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        multihost.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_choice():
    cpu = torch.device("cpu")
    assert multihost.choose_backend(cpu, 2)[0] == "gloo"


def test_collectives_and_their_gradients(tmp_path):
    """all_reduce and all_gather on the world and on a subgroup (ranks 1
    and 2); gather_slots' backward hands each rank its slice of the
    cotangent, sum_replicated's the cotangent itself (not summed over the
    ranks)."""
    world = 3
    res = du.run_ranks(du.collectives_worker, world, tmp_path)
    base = np.arange(4, dtype=np.float32)
    xs = [base + 10 * r for r in range(world)]
    w = np.arange(4 * world, dtype=np.float32)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r[0], sum(xs))
        np.testing.assert_array_equal(r[1], xs[0])
        np.testing.assert_array_equal(r[2], xs[-1])
        np.testing.assert_array_equal(r[3], np.concatenate(xs))
        np.testing.assert_array_equal(r[4], w[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r[5], w[:4])
        if rank >= 1:
            np.testing.assert_array_equal(r[6], xs[1] + xs[2])
            np.testing.assert_array_equal(r[7], np.concatenate(xs[1:]))


def test_diverging_rank_fails_fast(tmp_path):
    """A rank that leaves while the other waits in a collective makes
    the run fail within its timeout instead of hanging."""
    t0 = time.perf_counter()
    with pytest.raises(AssertionError, match="diverge_worker"):
        du.run_ranks(du.diverge_worker, 2, tmp_path, timeout=90)
    assert time.perf_counter() - t0 < 90
