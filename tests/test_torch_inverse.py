"""Port parity of the inverse-rendering train step: three Adam steps of
`rendering_tpu_torch.diff.inverse.make_train_step` on the CPU against
the JAX package's `make_train_step(optimizer=optax.adam(1e-2))`, on the
flagship (64x32, 2000 triangles, bench.py's three parameters) and on
the two-mesh scene (64x31, the fused K5 path, both meshes' vertices),
from the same primary rays (torch_port_util.shared_primary_rays) and
the same target image made with numpy from a seed.

Tolerance: the loss to rtol 1e-5; the parameters to atol 1e-5, a
thousandth of one Adam step (lr 1e-2). Adam divides each gradient by
its own running magnitude, so the gradients' f32 rounding differences
(tests/test_torch_grad.py) move a parameter by a tiny fraction of a
step; measured at most 4.9e-6 over the three steps.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rendering_tpu.render.pipeline as j_pipeline
from rendering_tpu.diff import inverse as j_inverse
from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu_torch.convert import params_from_numpy
from rendering_tpu_torch.diff import inverse as t_inverse
from rendering_tpu_torch.flagship import build_flagship_scene as t_flagship
from torch_port_util import jax_two_mesh_scene, port_scene, shared_primary_rays

BENCH_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
TWO_MESH_PATHS = (("lights", 0, "intensity"), ("obj_color",),
                  ("meshes", 0, "v"), ("meshes", 1, "v"))
LR = 1e-2


def _scene(name):
    if name == "flagship":
        return j_flagship(64, 32, n_tris=2000, with_maps=True,
                          settings_overrides=dict(pallas_interpret=True)), \
            BENCH_PATHS
    return jax_two_mesh_scene(height=31), TWO_MESH_PATHS


@pytest.mark.parametrize("name", ["flagship", "two_mesh"])
def test_adam_steps_match_optax(name):
    js, paths = _scene(name)
    ts = port_scene(js)
    st = js.static.settings
    target = np.random.default_rng(5).uniform(
        0, 1, (3, st.height, st.width)).astype(np.float32)
    v_before = ts.meshes[0].v.clone()
    with shared_primary_rays(js):
        j_init, j_step = j_inverse.make_train_step(
            paths, optimizer=optax.adam(LR),
            render_fn=lambda s: j_pipeline.render_scene.__wrapped__(s)[0])
        jp = j_inverse.extract_params(js, paths)
        j_state = j_init(jp)
        t_init, t_step = t_inverse.make_train_step(paths)
        tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")
        t_state = t_init(tp)
        for _ in range(3):
            jp, j_state, j_loss = j_step(jp, j_state, js,
                                         jnp.asarray(target))
            tp, t_state, t_loss = t_step(tp, t_state, ts,
                                         torch.from_numpy(target))
            np.testing.assert_allclose(float(t_loss), float(j_loss),
                                       rtol=1e-5)
            for k, v in jp.items():
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           np.asarray(v), rtol=0, atol=1e-5)
    # The vertices moved by about three steps; the scene kept its own.
    moved = np.abs(tp["meshes/0/v"].detach().numpy()
                   - v_before.numpy()).max()
    assert 2.5 * LR < moved < 3.5 * LR
    assert torch.equal(ts.meshes[0].v, v_before)


def test_apply_params_writes_nothing():
    """apply_params returns a new SceneData around the leaves; the scene,
    its other meshes and its chunk tables stay the same objects (the
    tables are not rebuilt after a vertex step, as in the JAX package)."""
    ts = t_flagship(32, 16, n_tris=300, device="cpu")
    paths = BENCH_PATHS
    params = t_inverse.extract_params(ts, paths)
    for k, v in params.items():
        assert v.is_leaf and v.requires_grad, k
    with torch.no_grad():
        params["meshes/0/v"].add_(0.05)
    new = t_inverse.apply_params(ts, params, paths)
    assert new is not ts and new.meshes[0] is not ts.meshes[0]
    assert new.meshes[0].v is params["meshes/0/v"]
    assert new.lights[0].intensity is params["lights/0/intensity"]
    assert new.lights[1] is ts.lights[1]
    assert new.meshes[0].itables is ts.meshes[0].itables
    assert not torch.equal(ts.meshes[0].v, new.meshes[0].v)
    assert t_inverse._get(new, ("obj_color",)) is params["obj_color"]


def test_repeat_steps_are_bit_equal():
    """Two steps from the same parameters and optimizer state give the
    same loss, gradients and parameters, bit for bit."""
    ts = port_scene(_scene("two_mesh")[0])
    paths = TWO_MESH_PATHS
    target = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (3, 31, 64)).astype(np.float32))
    init, step = t_inverse.make_train_step(paths)
    outs = []
    for _ in range(2):
        p = t_inverse.extract_params(ts, paths)
        p, state, loss = step(p, init(p), ts, target)
        outs.append((loss, {k: (v.detach().clone(), v.grad.clone())
                            for k, v in p.items()}))
    (l0, p0), (l1, p1) = outs
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k][0], p1[k][0]) and torch.equal(p0[k][1],
                                                               p1[k][1]), k


def test_deterministic_mode_is_restored():
    import torch.utils.deterministic as det

    prev = torch.are_deterministic_algorithms_enabled()
    prev_fill = det.fill_uninitialized_memory
    with t_inverse.deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert not det.fill_uninitialized_memory
    assert torch.are_deterministic_algorithms_enabled() == prev
    assert det.fill_uninitialized_memory == prev_fill


def test_params_from_numpy():
    p = params_from_numpy({"obj_color": np.ones((2, 3), np.float32),
                           "lights/0/intensity": np.float32(0.5)},
                          device="cpu")
    assert p["obj_color"].shape == (2, 3) and p["obj_color"].is_leaf
    assert p["lights/0/intensity"].requires_grad
    assert p["lights/0/intensity"].dtype == torch.float32
