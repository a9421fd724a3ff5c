"""The port's CUDA kernels on a card, against their plain PyTorch
versions. Each test skips without a CUDA device: a CUDA kernel has no
CPU mode, and the CPU tests (tests/test_torch_intersect.py) hold the
plain versions against the JAX package.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rendering_tpu_torch.flagship import build_flagship_scene
from rendering_tpu_torch.ops import cuda_intersect as ci
from rendering_tpu_torch.render.pipeline import quantize_u8, render_scene


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (3, n)).astype(np.float32)
    rd = np.asarray([[-0.1], [0.0], [-0.6]], np.float32) - ro
    rd[:, n // 2:] = rng.normal(0, 1, (3, n - n // 2))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tl = rng.uniform(0.05, 5.0, n).astype(np.float32)
    tl[rng.uniform(size=n) < 0.1] = -1.0
    return [torch.from_numpy(a) for a in (ro, rd, tl)]


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
@pytest.mark.parametrize("bfc", [True, False])
def test_kernel_matches_plain(cuda, anyhit, bfc):
    """Triangle ids equal and t bit-equal, on a ragged ray count with
    limits and resolved lanes."""
    scene = build_flagship_scene(128, 64, n_tris=20_000, device=cuda)
    tb = scene.meshes[0].itables
    ro, rd, tl = (x.to(cuda) for x in _rays(8 * 512 + 77, seed=1))
    prep = ci.prepare(tb, ro, rd, tl)
    kernel = ci.any_hit_kernel if anyhit else ci.closest_hit_kernel
    before = kernel.launches
    tk, rk = kernel(tb, prep, backface_culling=bfc)
    tp, rp = ci.intersect_plain(tb, prep, anyhit=anyhit, backface_culling=bfc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert int((rk >= 0).sum()) > 100
    assert torch.equal(rk, rp)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda):
    """The render through the kernels equals the CPU render of the same
    scene in u8 (within tests/test_golden.py's DEFAULT_TOL measures) and
    launches each kernel once per ray block."""
    scene = build_flagship_scene(128, 64, n_tris=20_000, device="cpu")
    cpu_u8 = quantize_u8(render_scene(scene)[0]).numpy()
    ci.closest_hit_kernel.launches = ci.any_hit_kernel.launches = 0
    gpu_u8 = quantize_u8(render_scene(scene.to(cuda))[0]).cpu().numpy()
    assert ci.closest_hit_kernel.launches == 1
    assert ci.any_hit_kernel.launches == 1
    d = np.abs(cpu_u8.astype(np.int16) - gpu_u8.astype(np.int16))[1:-1, 1:-1]
    assert (d > 1).mean() <= 0.006 and (d > 8).mean() <= 0.005
