#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from rendering_tpu_torch/csrc with nvcc,
then, on the 250k-triangle flagship scene at 3840x1080:

1. renders the full frame through `render_scene`, checks that both
   kernels were launched on that run, that the frame is finite and the
   mesh is hit, and times the forward pass (1 warm-up, 3 reps); the
   render keeps the two queries (primary rays, batched shadow rays) that
   one ray block hands to the kernels;
2. holds each kernel (closest hit, any hit) against its plain PyTorch
   version on 64 sampled 512-ray tiles of those queries: triangle ids
   equal, closest-hit t bit-equal, occlusion bits equal;
3. times each kernel, its plain version and its pre-pass on the whole
   queries (131072 primary and 262144 shadow rays), checks the two agree
   there too, and computes each kernel's bound;
4. renders at 384x216 with the kernels and with the plain versions on
   the card and requires equal u8 frames.

Prints the card, a JSON line of per-kernel numbers, and as its last line
{"ok": true, "device": {...}}. Any failed check raises, so the script
exits non-zero; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

N_TRIS = 250_000
WIDTH, HEIGHT = 3840, 1080
PARITY_WH = (384, 216)
SAMPLED_TILES = 64
HBM_RATE = 3.35e12      # H100 SXM bytes/s
# The kernel is built with -fmad=false, so every f32 multiply, add and
# compare issues on its own: one per lane per clock, 132 SMs x 128 lanes
# x 1.98 GHz = 33.5e12/s, half the data sheet's 67 TFLOP/s (which counts
# an FMA as two operations).
F32_OPS_RATE = 67e12 / 2
# f32 instructions per ray-triangle pair in the kernel's inner loop
# (csrc/mesh_intersect.cu): cross products p and q, 2 x (6 mul + 3 sub);
# det, 3 mul + 2 add; tv, 3 sub; u, v and t, 3 x (4 mul + 2 add); u + v,
# 1 add; 7 compares (det, u >= 0, u <= 1, v >= 0, u + v <= 1, t >= 0,
# t < t_best); 1 select (ok ? det : 1); and the IEEE reciprocal 1/det,
# MUFU.RCP plus 3 refinement instructions. Shared-memory loads, branches
# and predicate logic are left out, so the bound stays a lower bound.
OPS_PER_PAIR = 18 + 5 + 3 + 18 + 1 + 7 + 1 + 4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sample_tiles(ci, prep, n_tiles: int):
    """The n_tiles evenly spaced 512-ray tiles of a prepared query, with
    their own rows of the visit tables."""
    pick = torch.linspace(0, prep.n_tiles - 1, n_tiles).round().long()
    lanes = (pick[:, None] * ci.RAY_TILE
             + torch.arange(ci.RAY_TILE)[None, :]).reshape(-1)
    pick, lanes = pick.to(prep.aux.device), lanes.to(prep.aux.device)
    return ci.Prepared(prep.aux[:, lanes].contiguous(),
                       prep.torder[pick].contiguous(),
                       prep.counts[pick].contiguous(), lanes.numel())


def check_parity(ci, tb, prep, anyhit: bool, bfc: bool) -> float:
    """Kernel vs plain version on 64 sampled tiles of a prepared query.
    Returns the max |t| difference (0 when bit-equal); raises on any
    mismatch."""
    prep = sample_tiles(ci, prep, SAMPLED_TILES)
    kernel = ci.any_hit_kernel if anyhit else ci.closest_hit_kernel
    tk, rk = kernel(tb, prep, backface_culling=bfc)
    tp, rp = ci.intersect_plain(tb, prep, anyhit=anyhit, backface_culling=bfc)
    torch.cuda.synchronize()
    name = "any-hit" if anyhit else "closest-hit"
    tri_mis = int((rk != rp).sum())
    bits_mis = int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
    occ_mis = int(((rk >= 0) != (rp >= 0)).sum())
    hits = int((rk >= 0).sum())
    print(f"parity {name}: {prep.n_rays} rays in {SAMPLED_TILES} tiles, "
          f"{hits} hit/occluded; mismatches: tri {tri_mis}, t bits "
          f"{bits_mis}, occlusion {occ_mis}")
    if tri_mis or bits_mis or occ_mis or hits == 0:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version (or found nothing)")
    return float((tk - tp).abs().max())


def kernel_numbers(ci, tb, prep, anyhit: bool, bfc: bool) -> dict:
    """Times of the kernel, its plain version and the pre-pass on a
    prepared query of the main path, and the kernel's bound from this
    query's work. Also checks the kernel against its plain version on the
    whole query."""
    kernel = ci.any_hit_kernel if anyhit else ci.closest_hit_kernel
    ms = cuda_ms(lambda: kernel(tb, prep, backface_culling=bfc), reps=20)
    stats: dict = {}
    plain_ms = cuda_ms(lambda: ci.intersect_plain(
        tb, prep, anyhit=anyhit, backface_culling=bfc), reps=1)
    tp, rp = ci.intersect_plain(tb, prep, anyhit=anyhit,
                                backface_culling=bfc, stats=stats)
    tk, rk = kernel(tb, prep, backface_culling=bfc)
    if not (torch.equal(rk, rp)
            and torch.equal(tk.view(torch.int32), tp.view(torch.int32))):
        raise AssertionError("kernel disagrees with its plain version at "
                             "the main path's shape")
    n, aux = prep.n_rays, prep.aux
    prepass_ms = cuda_ms(
        lambda: ci.prepare(tb, aux[0:3, :n], aux[3:6, :n], aux[9, :n]), reps=5)
    n_in = sum(x.numel() * x.element_size()
               for x in (tb.tri, tb.cbox, prep.aux, prep.torder, prep.counts))
    n_out = prep.aux.shape[1] * 8
    bytes_ms = (n_in + n_out) / HBM_RATE * 1e3
    ops_ms = stats["pairs"] * OPS_PER_PAIR / F32_OPS_RATE * 1e3
    return {
        "rays": prep.n_rays, "pairs": stats["pairs"], "ms": ms,
        "plain_ms": plain_ms, "prepass_ms": prepass_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
    }


@contextlib.contextmanager
def routed_queries(ci, route):
    """Send the port's intersection queries through route(real, tb, prep,
    anyhit, backface_culling) instead of `ci.run_query`."""
    real = ci.run_query

    def query(tb, prep, *, anyhit, backface_culling):
        return route(real, tb, prep, anyhit, backface_culling)

    ci.run_query = query
    try:
        yield
    finally:
        ci.run_query = real


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.ops import cuda_intersect as ci
    from rendering_tpu_torch.render.pipeline import render_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line)

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    path, log = ci.build_library()
    print(f"built {path} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    torch.cuda.synchronize()
    tb = scene.meshes[0].itables
    print(f"flagship scene {N_TRIS} triangles at {WIDTH}x{HEIGHT} built in "
          f"{time.perf_counter() - t0:.1f} s; tables tc={tb.tri_chunk} "
          f"n_sub={tb.n_sub} Cs={tb.sbox.shape[0]}")
    bfc = scene.static.settings.use_backface_culling

    # ---- 1. full render through render_scene ------------------------------
    # The render keeps the (tables, prepared query) that the middle ray
    # block hands to each kernel, for phases 2 and 3.
    mid = (WIDTH * HEIGHT // (1 << 17)) // 2
    seen = {False: 0, True: 0}
    kept = {}

    def keep(real, tb_, prep, anyhit, backface_culling):
        if seen[anyhit] == mid:
            kept[anyhit] = (tb_, prep)
        seen[anyhit] += 1
        return real(tb_, prep, anyhit=anyhit, backface_culling=backface_culling)

    ci.closest_hit_kernel.launches = 0
    ci.any_hit_kernel.launches = 0
    with torch.no_grad(), routed_queries(ci, keep):
        frame3, _ = render_scene(scene)
    torch.cuda.synchronize()
    launches = {"closest_hit": ci.closest_hit_kernel.launches,
                "any_hit": ci.any_hit_kernel.launches}
    n_blocks = -(-WIDTH * HEIGHT // (1 << 17))
    print(f"render_scene launches: {launches} ({n_blocks} ray blocks)")
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the main path was not launched")
    if set(launches.values()) != {n_blocks}:
        raise AssertionError("expected one launch of each kernel per ray block")
    if tuple(frame3.shape) != (3, HEIGHT, WIDTH):
        raise AssertionError(f"frame shape {tuple(frame3.shape)}")
    if not bool(torch.isfinite(frame3).all()):
        raise AssertionError("frame is not finite")
    bg = scene.bg_color[:, None, None]
    interior = frame3[:, :-1, :-1]
    mesh_px = int((interior != bg).any(dim=0).sum())
    print(f"frame finite; {mesh_px} of {interior[0].numel()} pixels differ "
          f"from the background; mean {float(frame3.mean()):.6f}")
    if mesh_px < 0.05 * interior[0].numel():
        raise AssertionError("the mesh is not hit")

    def forward():
        with torch.no_grad():
            render_scene(scene)

    frame_ms = cuda_ms(forward, reps=3)
    rays = WIDTH * HEIGHT
    print(f"forward frame {WIDTH}x{HEIGHT}, {N_TRIS} triangles: "
          f"{frame_ms:.3f} ms, {rays / frame_ms * 1e3:.4e} rays/s "
          f"(CUDA events, mean of 3 after 1 warm-up) on {card_line}")

    # ---- 2. kernel vs plain on sampled tiles of the kept queries -----------
    err = {
        "closest_hit": check_parity(ci, *kept[False], False, bfc),
        "any_hit": check_parity(ci, *kept[True], True, bfc),
    }

    # ---- 3. per-kernel numbers on the kept queries -------------------------
    nums = {
        "closest_hit": kernel_numbers(ci, *kept[False], False, bfc),
        "any_hit": kernel_numbers(ci, *kept[True], True, bfc),
    }
    for k, v in nums.items():
        print(f"{k}: {json.dumps(v)}")

    # ---- 4. whole-render parity, kernels vs plain versions ------------------
    def plain(real, tb_, prep, anyhit, backface_culling):
        return ci.intersect_plain(tb_, prep, anyhit=anyhit,
                                  backface_culling=backface_culling)

    small = build_flagship_scene(*PARITY_WH, n_tris=N_TRIS)
    with torch.no_grad():
        u8_k, _ = render_scene(small, out_u8=True)
        with routed_queries(ci, plain):
            u8_p, _ = render_scene(small, out_u8=True)
    n_diff = int((u8_k != u8_p).sum())
    print(f"whole-render parity {PARITY_WH[0]}x{PARITY_WH[1]}: {n_diff} "
          f"differing u8 values")
    if n_diff:
        raise AssertionError("kernel and plain renders disagree")

    kernels = []
    for name in ("closest_hit", "any_hit"):
        n = nums[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rendering_tpu_torch/csrc/mesh_intersect.cu",
            "replaces": "rendering_tpu/ops/pallas_intersect.py:135",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": n["ms"], "plain_ms": n["plain_ms"],
            "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"frame_ms": frame_ms, "rays_per_s": rays / frame_ms * 1e3,
                      "card": card_line}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
