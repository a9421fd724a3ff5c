"""Traffic kind `train`: inverse-rendering train steps back to back.

Set-up renders the target from the scene at the seed's true parameters,
builds the scene at the start (the light intensities and colours in
start_moved at start_scale x true + start_shift; every mesh displaced by
a smooth field of amplitude start_displace, a function of position, so
the surface stays closed), builds the program's train step (`diff.
inverse.make_train_step`, Adam with a learning rate per parameter) and
runs its first `check_steps` steps through that same step: their losses,
the first gradient (from Adam's first moment after one step) and the
parameters' change are what the reference follows from the same two
scenes. The window then runs the same step on the same object. A request
is one step; a step whose loss is not finite, or whose transparent queue
dropped paths, failed.

Workload parameters ("params"): paths, lr {path: lr}, start_moved,
start_scale, start_shift, start_displace, true_jitter (each true light
intensity and object colour scaled by 1 + true_jitter * u, u uniform in
[-1, 1] from the seed), check_steps, settings (scene settings replaced
for training, e.g. SSAA off).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from harness import scenes
from reference import compare, render as ref_render, train as ref_train

BETA1 = 0.9


def _key(path) -> str:
    return "/".join(map(str, path))


def _true_desc(ctx) -> dict:
    p = ctx.cell["params"]
    desc = scenes.describe(ctx.cfg, ctx.seed, {**p.get("settings", {}),
                                               **ctx.overrides})
    rng = np.random.default_rng([ctx.seed, 1])
    jit = float(p.get("true_jitter", 0.0))
    for li in desc["lights"]:
        li["intensity"] = float(li["intensity"]) * (1 + jit * rng.uniform(-1, 1))
    for o in desc["objects"]:
        o["color"] = [float(c) * (1 + jit * rng.uniform(-1, 1))
                      for c in o["color"]]
    return desc


def _start_desc(desc: dict, p: dict, seed: int) -> dict:
    start = copy.deepcopy(desc)
    moved = set(p["start_moved"])
    for i, li in enumerate(start["lights"]):
        if f"lights/{i}/intensity" in moved:
            li["intensity"] = li["intensity"] * p["start_scale"] + p["start_shift"]
    if "obj_color" in moved:
        for o in start["objects"]:
            o["color"] = [c * p["start_scale"] + p["start_shift"]
                          for c in o["color"]]
    amp = float(p.get("start_displace", 0.0))
    rng = np.random.default_rng([seed, 4])
    for o in start["objects"]:
        if o["type"] != "mesh" or amp == 0.0:
            continue
        a = o["arrays"]
        v = a["v"].astype(np.float64)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        field = np.stack([np.sin(9.0 * v[..., (c + 1) % 3] + ph[c])
                          * np.cos(7.0 * v[..., (c + 2) % 3]) for c in range(3)],
                         -1)
        v = (v + amp * field).astype(np.float32)
        lo = np.minimum(a["root_bounds"][0], v.min(axis=(0, 1)) - 1e-3)
        hi = np.maximum(a["root_bounds"][1], v.max(axis=(0, 1)) + 1e-3)
        o["arrays"] = {**a, "v": v,
                       "root_bounds": np.stack([lo, hi]).astype(np.float32)}
    return start


def setup(ctx):
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.render.pipeline import render_scene

    p = ctx.cell["params"]
    desc = _true_desc(ctx)
    with torch.no_grad():
        target = render_scene(scenes.program_scene(desc, ctx.device))[0]
    start = _start_desc(desc, p, ctx.seed)
    start_scene = scenes.program_scene(start, ctx.device)
    paths = tuple(tuple(x) for x in p["paths"])
    keys = [_key(x) for x in paths]
    lrs = [float(p["lr"][k]) for k in keys]

    def optimizer(ps):
        return torch.optim.Adam([{"params": [t], "lr": lr}
                                 for t, lr in zip(ps, lrs)],
                                betas=(BETA1, 0.999), eps=1e-8)

    dropped = []

    def render_fn(s):
        frame, aux = render_scene(s)
        dropped.append(aux["stats"]["paths_dropped"])
        return frame

    init_fn, step_fn = make_train_step(paths, optimizer=optimizer,
                                       render_fn=render_fn)
    params = extract_params(start_scene, paths)
    opt = init_fn(params)
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, grad_norms = [], {}
    for i in range(int(p["check_steps"])):
        params, opt, loss = step_fn(params, opt, start_scene, target)
        losses.append(float(loss))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(
                opt.state[v]["exp_avg"] / (1 - BETA1))) for k, v in params.items()}
    delta = {k: float(torch.linalg.vector_norm(v.detach() - p0[k]))
             for k, v in params.items()}
    st = desc["settings"]
    return {"desc": desc, "start": start, "keys": keys,
            "lrs": dict(zip(keys, lrs)),
            "params": params, "opt": opt, "scene": start_scene,
            "target": target, "step_fn": step_fn, "dropped": dropped,
            "n_drop_setup": len(dropped), "losses": [],
            "rays": int(st["width"]) * int(st["height"]),
            "prog": {"losses": losses, "grad_norms": grad_norms,
                     "delta_norms": delta},
            "check_steps": int(p["check_steps"]), "device": ctx.device}


def request(state):
    state["params"], state["opt"], loss = state["step_fn"](
        state["params"], state["opt"], state["scene"], state["target"])
    state["losses"].append(loss)
    return {}


def finish(state, records):
    window_drops = state["dropped"][state["n_drop_setup"]:]
    for rec, loss, drop in zip(records, state["losses"], window_drops):
        if not bool(torch.isfinite(loss)) or float(drop) > 0:
            rec["ok"] = False


def end_to_end(state, records, window_s):
    done = sum(1 for r in records if r["ok"])
    return {"train_rays_per_s": state["rays"] * done / window_s}


def release(state):
    for k in ("params", "opt", "scene", "target", "step_fn", "dropped",
              "losses"):
        state.pop(k, None)


def reference_numbers(state, dtype) -> dict:
    """The reference's losses, first gradient and change over the same
    steps, from the same inputs, in `dtype` (computed once a state)."""
    cache = state.setdefault("ref_cache", {})
    if dtype in cache:
        return cache[dtype]
    with torch.no_grad():
        target = ref_render.render(ref_render.build(
            state["desc"], device=state["device"], dtype=dtype)).float()
    scene = ref_render.build(state["start"], device=state["device"],
                             dtype=dtype)
    start = {k: scene.get(k).detach().clone() for k in state["keys"]}
    cache[dtype] = ref_train.replay(scene, target, start, state["lrs"],
                                    state["check_steps"])
    return cache[dtype]


def check(state, records, dtype):
    return compare.train_gaps(state["prog"], reference_numbers(state, dtype))


def control(state, records, dtype):
    """The reference in `dtype` in the program's place."""
    return compare.train_gaps(reference_numbers(state, dtype),
                              reference_numbers(state, torch.float32))
