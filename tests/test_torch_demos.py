"""The port's demos (examples/*_torch.py) on the CPU at a tiny size: each
`main(argv)` runs 2-3 steps or frames with `--device cpu`, and the loss
falls. The camera demo's optimizer (clip, then Adam on a cosine
schedule) is held against optax's chain on a seeded problem within atol
1e-5, tests/test_torch_inverse.py's limit for Adam's parameters: the same
update in f32, rounded in another order (torch applies Adam's bias
corrections to the step size and the denominator, optax to the moments;
the schedule's factor is computed in float64 here, in f32 there), which
moves a parameter by ulps of its 0.05 step (measured: up to 1.1e-6 after
six steps)."""

from __future__ import annotations

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _losses(out: str) -> list:
    return [float(m) for m in re.findall(r"^step +\d+  loss (\S+)", out,
                                         re.M)]


def _t01_at(tmp_path, w=48, h=32):
    """tests/scenes/t01_simple_shapes.scene at w x h in tmp_path."""
    with open(os.path.join(REPO, "tests", "scenes",
                           "t01_simple_shapes.scene")) as fh:
        text = fh.read()
    text = text.replace("width=320", f"width={w}").replace(
        "height=240", f"height={h}")
    path = str(tmp_path / "t01.scene")
    with open(path, "w") as fh:
        fh.write(text)
    return path


@pytest.mark.parametrize("camera", [False, True])
def test_inverse_demo_loss_falls(tmp_path, capsys, camera):
    demo = _demo("inverse_demo_torch")
    argv = [_t01_at(tmp_path), "--steps", "3", "--device", "cpu"]
    if camera:
        argv += ["--camera", "--lr", "0.005"]
    assert demo.main(argv) == 0
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 2 and losses[-1] < losses[0], out
    assert ("recovered pose" in out) == camera


def test_texture_paint_demo_loss_falls(tmp_path, capsys):
    demo = _demo("texture_paint_demo_torch")
    out_dir = str(tmp_path / "paint")
    assert demo.main(["--steps", "3", "--width", "48", "--height", "32",
                      "--tris", "2000", "--out", out_dir,
                      "--device", "cpu"]) == 0
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 2 and losses[-1] < losses[0]
    with open(os.path.join(out_dir, "convergence.json")) as fh:
        res = json.load(fh)
    assert res["platform"] == "cpu" and res["steps"] == 3
    assert 0 < res["covered_texels"] < 64 * 64
    assert res["final_covered_mae"] < res["start_covered_mae"]
    for name in ("target", "start", "recovered"):
        img = bmp_to_image(load_bmp(os.path.join(out_dir, f"{name}.bmp")))
        assert img.shape == (32, 48, 3)
    for name in ("map_true", "map_start", "map_recovered"):
        img = bmp_to_image(load_bmp(os.path.join(out_dir, f"{name}.bmp")))
        assert img.shape == (64, 64, 3)


def test_turntable_demo_writes_frames(tmp_path, capsys):
    demo = _demo("turntable_demo_torch")
    out_dir = str(tmp_path / "tt")
    assert demo.main([_t01_at(tmp_path, 32, 24), "--frames", "3", "--out",
                      out_dir, "--device", "cpu"]) == 0
    frames = [bmp_to_image(load_bmp(os.path.join(out_dir,
                                                 f"frame_{i:04d}.bmp")))
              for i in range(3)]
    assert all(f.shape == (24, 32, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[1])


def test_clipped_cosine_adam_matches_optax():
    """Six steps on sum(w * p^2) with gradients above the clip norm: the
    parameters after each step within atol 1e-5 of optax's chain of
    clip_by_global_norm(1.0) and adam(cosine_decay_schedule(lr, 4,
    0.02)), past the schedule's end too."""
    demo = _demo("inverse_demo_torch")
    rng = np.random.default_rng(5)
    p0 = {"pos": rng.normal(size=3).astype(np.float32),
          "angles_deg": rng.normal(size=3).astype(np.float32) * 3}
    w = {k: rng.random(3).astype(np.float32) * 4 for k in p0}
    lr, steps = 0.05, 4

    def loss(p):
        return sum(jnp.sum(w[k] * p[k] ** 2) for k in p)

    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.cosine_decay_schedule(lr, steps, 0.02)))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = demo.ClippedCosineAdam(list(tp.values()), lr, steps)
    for _ in range(6):
        updates, state = opt.update(jax.grad(loss)(jp), state)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        sum((torch.from_numpy(w[k]) * tp[k] ** 2).sum() for k in tp).backward()
        topt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=1e-5)
