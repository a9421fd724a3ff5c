"""Traffic kind `turntable`: frames served to a host, one camera after
another around the scene (the port's turntable serving, `render(...,
out_u8=True)` per camera, each frame pulled to the host).

The cameras: `n_cameras` evenly spaced on a circle around the centroid
of the scene's spheres, at the radius and elevation of the file's own
camera, each aimed at the centroid; the window cycles through them from
a start camera that the seed picks, so every seed serves the same views
in another order. A request is one frame, timed from the call to the
u8 frame on the host. After the window the reference renders a sample of
the served frames, drawn from the seed, and each is compared with it.

Workload parameters ("params"): n_cameras, n_checked, warmup_frames.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from harness import scenes
from reference import compare, render as ref_render


def look_at(pos, target):
    """Euler degrees (roll-free, upright) aiming the engine's camera,
    whose forward is (0, 0, -1) @ R, from pos at target."""
    d = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    dx, dy, dz = d / np.linalg.norm(d)
    h = math.hypot(dy, dz)
    if h == 0.0:
        return [0.0, math.copysign(90.0, dx), 0.0]
    cy = -h if dz > 0 else h
    return [math.degrees(math.atan2(-dy / cy, -dz / cy)),
            math.degrees(math.atan2(dx, cy)), 0.0]


def cameras(desc: dict, n: int) -> list:
    centers = [o["pos"] for o in desc["objects"] if o["type"] == "sphere"]
    center = np.mean(np.asarray(centers, np.float64), axis=0)
    off = np.asarray(desc["camera"]["position"], np.float64) - center
    radius = float(np.linalg.norm(off))
    el = math.asin(off[1] / radius)
    out = []
    for k in range(n):
        th = math.radians(360.0 * k / n)
        pos = center + radius * np.array([math.sin(th) * math.cos(el),
                                          math.sin(el),
                                          math.cos(th) * math.cos(el)])
        out.append((pos.tolist(), look_at(pos, center)))
    return out


def setup(ctx):
    from rendering_tpu_torch.models.scene import load_scene
    from rendering_tpu_torch.render.animation import set_camera
    from rendering_tpu_torch.render.pipeline import render

    p = ctx.cell["params"]
    desc = scenes.describe(ctx.cfg, ctx.seed, ctx.overrides)
    path = scenes.write_scene_files(desc, ctx.workdir, ctx.name)
    n = int(p["n_cameras"])
    first = int(np.random.default_rng([ctx.seed, 2]).integers(n))
    cams = cameras(desc, n)
    state = {"desc": desc, "device": ctx.device,
             "cams": cams[first:] + cams[:first],
             "scene": load_scene(path, device=ctx.device),
             "set_camera": set_camera, "render": render, "frames": [],
             "seed": ctx.seed, "n_checked": int(p["n_checked"]),
             "pixels": int(desc["settings"]["width"])
             * int(desc["settings"]["height"])}
    for k in range(int(p["warmup_frames"])):
        _frame(state, k)
    return state


def _frame(state, k):
    pos, rot = state["cams"][k % len(state["cams"])]
    s = state["set_camera"](state["scene"], pos, rot_deg=rot)
    frame, _ = state["render"](s, out_u8=True)
    return frame


def request(state):
    k = len(state["frames"])
    frame = _frame(state, k)
    state["frames"].append((k % len(state["cams"]), frame))
    return {}


def finish(state, records):
    return None


def end_to_end(state, records, window_s):
    ok = [r for r in records if r["ok"]]
    lat_ms = [(r["end"] - r["start"]) * 1e3 for r in ok]
    return {"frame_rays_per_s": state["pixels"] * len(ok) / window_s,
            "frame_p95_ms": float(np.percentile(lat_ms, 95))
            if lat_ms else float("inf")}


def release(state):
    for k in ("scene", "set_camera", "render"):
        state.pop(k, None)


def _sample(state, records) -> list:
    """The served (camera, frame) pairs the comparison reads: n_checked
    of them, drawn from the seed."""
    served = [(cam, fr) for rec, (cam, fr) in zip(records, state["frames"])
              if rec["ok"]]
    rng = np.random.default_rng([state["seed"], 3])
    picks = rng.choice(len(served), size=min(state["n_checked"], len(served)),
                       replace=False)
    return [served[i] for i in sorted(picks.tolist())]


def _reference(state, cam, dtype):
    desc = copy.deepcopy(state["desc"])
    desc["camera"] = {"position": state["cams"][cam][0],
                      "rotation": state["cams"][cam][1]}
    scene = ref_render.build(desc, device=state["device"], dtype=dtype)
    with torch.no_grad():
        return ref_render.quantize(ref_render.render(scene))


def check(state, records, dtype):
    sample = _sample(state, records)
    if not sample:
        return {"bad8_share": 1.0, "mean_abs_u8": 255.0}
    return compare.worst([compare.frame_gaps(fr, _reference(state, cam, dtype))
                          for cam, fr in sample])


def control(state, records, dtype):
    """The reference in `dtype` in the program's place, on the same
    sample."""
    return compare.worst([compare.frame_gaps(
        _reference(state, cam, dtype), _reference(state, cam, torch.float32))
        for cam, _ in _sample(state, records)])
