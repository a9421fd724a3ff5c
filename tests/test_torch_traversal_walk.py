"""The closest-hit walk of the port (`ops.traversal.traverse_bvh_plain`,
the plain version of csrc/bvh_walk.cu's `bvh_closest_kernel`) against
the JAX package's `traverse_bvh` on the CPU, over the same flat BVH: a
400-triangle procedural mesh carried across from the JAX scene, seeded
rays aimed at it from around, leaving its surface from inside, random
and axis-parallel ones (1/rd = +-inf), with and without t limits (-1 on a
share of the lanes: rays already resolved), at useAC 1 and 0, with and
without pruning and backface culling; and a mesh without nodes.

Tolerance: none. Triangle ids, t, u and v are bit-equal and the box and
triangle counters equal: the walk visits the same nodes in the same
order and does the same f32 operations. JAX runs eagerly here
(jax.disable_jit): its jitted while loop is XLA CPU code, which contracts
the Moller-Trumbore sums' multiply-adds into FMAs (the port, the kernel
and the reference do not; tests/test_torch_anyhit_walk.py). The kernel
against this plain version: tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu.ops.traversal import traverse_bvh as j_traverse_bvh
from rendering_tpu_torch.ops import traversal
from torch_port_util import port_scene

N_RAYS = 1536
CASES = {
    "closest": dict(limit=False),
    "t_limit": dict(limit=True),
    "no_ac": dict(limit=True, use_ac=False),
    "no_prune": dict(limit=True, prune=False),
    "no_culling": dict(limit=False, backface_culling=False),
}


@pytest.fixture(scope="module")
def meshes():
    js = j_flagship(64, 32, n_tris=256, with_maps=False)
    return js.meshes[0], port_scene(js).meshes[0]


def seeded_rays(n, seed, aim=(-0.1, 0.0, -0.6)):
    """(ro, rd, t_limit) (n, 3), (n, 3), (n,) f32: a quarter aimed at
    `aim` from around it, a quarter leaving points near the surface, the
    rest random; one ray in 16 with a zero direction component; limits
    in (0.05, 4), -1 on one lane in 8."""
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    a = np.asarray(aim, np.float32)
    q = n // 4
    rd[:q] = a - ro[:q]
    ro[q:2 * q] = a + rng.normal(0, 0.6, (q, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    axis = rng.integers(0, 3, n)
    zero = np.arange(n) % 16 == 5
    rd[zero, axis[zero]] = 0.0
    tl = rng.uniform(0.05, 4.0, n).astype(np.float32)
    tl[np.arange(n) % 8 == 3] = -1.0
    return ro, rd, tl


def _walks(jm, tm, limit, **kw):
    ro, rd, tl = seeded_rays(N_RAYS, seed=11)
    with jax.disable_jit():
        jr = j_traverse_bvh(jm, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(tl) if limit else None, **kw)
    tr = traversal.traverse_bvh(
        tm, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tl) if limit else None, **kw)
    return jr, tr


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_jax(meshes, case):
    """Ids, t, u, v bit-equal and both counters equal to JAX's walk."""
    jr, tr = _walks(*meshes, **CASES[case])
    tri = np.asarray(jr.tri)
    np.testing.assert_array_equal(tr.tri.numpy(), tri)
    assert (tri >= 0).sum() > N_RAYS // 8
    for name in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(tr, name).numpy().view(np.int32),
            np.asarray(getattr(jr, name)).view(np.int32), err_msg=name)
    assert int(tr.box_tests) == int(jr.box_tests)
    assert int(tr.tri_tests) == int(jr.tri_tests)
    assert (int(tr.box_tests) == 0) == (not CASES[case].get("use_ac", True))


def test_walk_limits_and_pruning(meshes):
    """A t limit only removes hits (the ones at or beyond it, every hit of
    a resolved lane) and reads FLT_MAX where nothing was taken; pruning
    saves work without changing a closest hit."""
    jm, tm = meshes
    ro, rd, tl = (torch.from_numpy(a) for a in seeded_rays(N_RAYS, seed=11))
    free = traversal.traverse_bvh(tm, ro, rd)
    lim = traversal.traverse_bvh(tm, ro, rd, tl)
    unpruned = traversal.traverse_bvh(tm, ro, rd, tl, prune=False)
    keep = free.t < tl
    assert torch.equal(lim.tri, torch.where(keep, free.tri, -1))
    assert torch.equal(lim.t, torch.where(keep, free.t,
                                          torch.tensor(np.float32(3.4028235e38))))
    assert not bool(((tl < 0) & (lim.tri >= 0)).any())
    assert torch.equal(unpruned.tri, free.tri)
    assert int(free.box_tests) < int(unpruned.box_tests)
    assert int(lim.tri_tests) < int(free.tri_tests)


def test_walk_without_nodes():
    """A tree without nodes: FLT_MAX and -1 everywhere (not the t limit),
    no tests, in both packages."""
    empty = dict(node_min=np.zeros((0, 3), np.float32),
                 node_max=np.zeros((0, 3), np.float32),
                 skip=np.zeros((0,), np.int32),
                 leaf_start=np.zeros((0,), np.int32),
                 leaf_count=np.zeros((0,), np.int32),
                 real_flag=np.zeros((0,), np.int32),
                 leaf_tris=np.zeros((8,), np.int32),
                 v=np.zeros((0, 3, 3), np.float32))
    ro, rd, tl = seeded_rays(64, seed=2)
    jr = j_traverse_bvh(
        types.SimpleNamespace(**{k: jnp.asarray(a) for k, a in empty.items()},
                              leaf_chunk=8),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tl))
    tr = traversal.traverse_bvh(
        types.SimpleNamespace(**{k: torch.from_numpy(a)
                                 for k, a in empty.items()}),
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tl))
    np.testing.assert_array_equal(tr.t.numpy(), np.asarray(jr.t))
    np.testing.assert_array_equal(tr.tri.numpy(), np.asarray(jr.tri))
    assert (tr.tri.numpy() == -1).all() and (tr.t.numpy() > 3e38).all()
    assert int(tr.box_tests) == int(jr.box_tests) == 0
    assert int(tr.tri_tests) == int(jr.tri_tests) == 0


def test_walk_raises_off_cpu_and_cuda(meshes):
    """The dispatch takes the kernel for CUDA tensors, the plain version
    for CPU tensors, and raises for another device; the kernel's wrapper
    raises for CPU tensors instead of falling back to the plain walk."""
    _, tm = meshes
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no BVH walk"):
        traversal.traverse_bvh(tm, meta, meta)
    ro, rd = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        traversal.traverse_bvh_kernel(tm, ro, rd, torch.zeros(4))
