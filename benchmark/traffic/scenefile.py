"""Traffic kind `scenefile`: the upstream engine's one mode of use, a
`.scene` file to a BMP, through the program's command line
(`rendering_tpu_torch.cli.main([scene, "--output", bmp])`) again and
again. Each call parses the file, loads the OBJ, builds the BVH and the
tables, renders the frame (strips and SSAA as the file's options say)
and writes the BMP.

Set-up writes the scene file, its OBJ and maps into the run's temporary
directory and makes one call (which builds the kernels). Each call of
the window writes its own BMP; after the window the reference renders the
scene file once and every BMP is compared with it. The CLI's own "Scene
loading" timer line (enableOutput=1) is kept per call.
"""

from __future__ import annotations

import contextlib
import io
import os
import re

import torch

from harness import scenes
from reference import compare, files, render as ref_render

_LOAD = re.compile(r"^Scene loading\s+(\d+) ms", re.M)


def setup(ctx):
    from rendering_tpu_torch import cli

    desc = scenes.describe(ctx.cfg, ctx.seed, ctx.overrides)
    path = scenes.write_scene_files(desc, ctx.workdir, ctx.name)
    state = {"cli": cli, "scene": path, "workdir": ctx.workdir,
             "device": ctx.device, "outputs": [],
             "kw": {} if ctx.device.type == "cuda" else {"device": "cpu"}}
    with contextlib.redirect_stdout(io.StringIO()):
        _call(state, os.path.join(ctx.workdir, "warmup.bmp"))
    return state


def _call(state, out):
    rc = state["cli"].main([state["scene"], "--output", out], **state["kw"])
    if rc != 0 or not os.path.exists(out):
        raise RuntimeError(f"cli.main returned {rc} without writing {out}")


def request(state):
    out = os.path.join(state["workdir"], f"call{len(state['outputs']):04d}.bmp")
    state["outputs"].append(out)
    _call(state, out)
    return {}


def finish(state, records):
    for rec in records:
        m = _LOAD.search(rec["stdout"])
        if m:
            rec["scene_load_ms"] = float(m.group(1))


def end_to_end(state, records, window_s):
    done = sum(1 for r in records if r["ok"])
    return {"scene_to_bmp_s": window_s / done if done else float("inf")}


def release(state):
    state.pop("cli", None)


def _reference(state, dtype):
    scene = ref_render.build(files.parse_scene(state["scene"]),
                             device=state["device"], dtype=dtype)
    with torch.no_grad():
        return ref_render.quantize(ref_render.render(scene))


def check(state, records, dtype):
    ref = _reference(state, dtype)
    gaps = []
    for rec, out in zip(records, state["outputs"]):
        if rec["ok"] and os.path.exists(out):
            gaps.append(compare.frame_gaps(files.read_image(out), ref))
            os.remove(out)
    return compare.worst(gaps) if gaps else {"bad8_share": 1.0,
                                             "mean_abs_u8": 255.0}


def control(state, records, dtype):
    """The reference in `dtype` in the program's place."""
    return compare.frame_gaps(_reference(state, dtype),
                              _reference(state, torch.float32))
