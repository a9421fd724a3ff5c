#!/usr/bin/env python3
"""What sets the closest hit's time on the card: the closest-hit queries
of the flagship, the 16-mesh scene and the bouncing frame, their work
counts and tile timelines, on the walks of
rendering_tpu_torch/csrc/mesh_intersect.cu.

    python3 tools/closest_walk_torch.py [--walks tile,cluster1,...]
                                        [--frames tile,cluster1]

The walks: `clusterG` for G in ops/cuda_intersect.py CLUSTER_SIZES, the
closest walk every render path launches (`closest_walk_kernel`: a
512-ray tile split by rays over a thread block cluster of G CTAs that
agree on the tile-live sub-chunks through distributed shared memory,
heaviest tiles first, the super's cull once per ray, staging
overlapped with compute), and `tile`, the one-CTA-per-tile walk it
replaced (`*closest_hit_tile_walk*`, kept only to be timed against it).
The render paths run `cluster{CLOSEST_CLUSTER}`.

1. Keeps the middle ray block's closest-hit query of the flagship
   (250k triangles, 3840x1080: K1) and of the 16-mesh scene (16 x 5000
   triangles, 1920x1080: K5), and renders build_tiny_scene at 3840x1080
   with the 250k procedural mesh (5 bounces of 32 ray blocks, one
   closest hit each) once per walk under torch.profiler: the closest-hit
   kernels' summed device time per bounce beside the frame time, the
   frame's device busy time and idle share, and the same sums from CUDA
   events around each query. The bouncing frame keeps bounce 0's middle
   query and bounce 2's query with the most live (tile, super) pairs.
2. On each kept query: the plain version's work (`pairs` the per-ray
   cull needs, `union_pairs` the tile's unresolved rays evaluate,
   `warp_pairs` the 32-lane warps holding one issue, `packed_pairs`
   with the unresolved rays packed into the lowest lanes,
   `tile_union_max` the heaviest tile's union) and its bounds at 57 f32
   instructions a pair and 33.5e12/s (the heaviest tile at 1/132 of the
   rate, on one SM; a cluster of G CTAs splits it G ways); the tile walk
   and the shipped closest walk in turns (tile, new, new, tile by
   `utils.timer.mean_ms`), each of the cluster sizes in turns (1, 2, 4,
   4, 2, 1), every walk held bit-equal to the plain version first; and
   each walk's tile timeline (longest and mean tile, the tail from the
   95th-percentile tile end, the span) with its resources (CTAs per SM,
   resident clusters, registers, spills).
3. The SASS of the built library: per kernel the instructions and
   shared loads per ray-triangle pair in its innermost loop holding the
   pair test's reciprocal (one MUFU.RCP a pair).

Prints the card's name and power limit, then one JSON line. Raises
without a CUDA device. chip_smoke.py runs the same measurements through
this module's functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import anyhit_walk_torch as aw  # noqa: E402

from rendering_tpu_torch.device import (  # noqa: E402
    describe_card,
    resolve_device,
)
from rendering_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from rendering_tpu_torch.utils.timer import mean_ms  # noqa: E402

WIDTH, HEIGHT, N_TRIS = 3840, 1080, 250_000
MM_WIDTH, MM_HEIGHT, MM_MESHES, MM_TRIS = 1920, 1080, 16, 5000
RAY_BLOCK = aw.RAY_BLOCK
REPS = aw.REPS
WALKS = ("tile",) + tuple(f"cluster{g}" for g in ci.CLUSTER_SIZES)
SHIPPED = f"cluster{ci.CLOSEST_CLUSTER}"
def walk_kernel_re(walk: str):
    """A walk's closest-hit kernel, by its name in the profiler's trace."""
    return re.compile(r"mesh_intersect_kernel<false" if walk == "tile"
                      else r"closest_walk_kernel")


def walk_kernel(name: str, walk: str) -> ci.CudaKernel:
    """The kernel of closest-hit variant `name` (ops/cuda_intersect.py
    KERNELS) on walk `walk`: the variant itself for a cluster walk, its
    `_tile_walk` twin for the tile walk (fused, root filter and counters
    kept)."""
    k = ci.KERNELS[name]
    if k.anyhit:
        raise ValueError(f"{name} is not a closest hit")
    if walk == "tile":
        return ci.KERNELS[ci.variant_name(
            anyhit=False, fused=k.fused, root_filter=k.root_filter,
            collect_stats=k.collect_stats, tile_walk=True)]
    return k


def walk_config(walk: str) -> tuple[int, int | None]:
    """(CTAs per cluster, split factor or None for SPLIT_FACTOR) of a walk
    name: `clusterG`, or `clusterGfF` for split factor F (0: every tile
    with a live super splits); the tile walk is (1, None)."""
    if walk == "tile":
        return 1, None
    g, _, f = walk[len("cluster"):].partition("f")
    return int(g), int(f) if f else None


def run_walk(name, walk, tables, prep, bfc, timing=None):
    """Closest-hit query `name` on walk `walk` (fused tables pass their
    idmap)."""
    fused = isinstance(tables, ci.FusedTables)
    g, f = walk_config(walk)
    if f is not None:
        prep = dataclasses.replace(
            prep, n_split=ci.tile_schedule(prep.counts, f)[1])
    return walk_kernel(name, walk)(
        tables.geo if fused else tables, prep, backface_culling=bfc,
        idmap=tables.idmap if fused else None, timing=timing, cluster=g)


def walk_profile(name, walk, tables, prep, bfc) -> dict:
    """One walk on a query: its tile timeline (TIMING variant, one
    launch), its resources and the tiles it split."""
    timing = torch.zeros((prep.n_tiles, 3), dtype=torch.int64,
                         device=prep.aux.device)
    run_walk(name, walk, tables, prep, bfc, timing=timing)
    g, f = walk_config(walk)
    split = (0 if walk == "tile" or g == 1 else
             int(ci.tile_schedule(prep.counts, f)[1]))
    res = ci.resources(walk_kernel(name, walk).name, cluster=g)
    return {**aw.tile_summary(timing), **res, "split_tiles": split}


def walk_ab(name, tables, prep, bfc, ref, reps=REPS,
            walks=WALKS) -> dict:
    """A closest-hit query on each of `walks`, each first held bit-equal
    to the plain version's outputs `ref` (counters too); then, where the
    tile walk and the shipped walk are both in `walks`, the two in turns
    (tile, shipped, shipped, tile; `ms` and `tile_walk_ms` the means of
    two), the cluster sizes in turns (1, 2, 4, 4, 2, 1: `cluster_ms`), and
    each walk's tile timeline and resources."""
    for walk in walks:
        if not aw.same(run_walk(name, walk, tables, prep, bfc), ref):
            raise AssertionError(f"{name} on the {walk} walk disagrees with "
                                 f"its plain version")

    def timed(walk):
        return mean_ms(lambda: run_walk(name, walk, tables, prep, bfc),
                       reps=reps)

    out: dict = {}
    if "tile" in walks and SHIPPED in walks:
        ab = [timed(w) for w in ("tile", SHIPPED, SHIPPED, "tile")]
        out.update(ms=(ab[1] + ab[2]) / 2, tile_walk_ms=(ab[0] + ab[3]) / 2,
                   ab_ms=ab)
    clusters = [w for w in walks if w != "tile"]
    if clusters:
        runs: dict = {}
        for w in clusters + clusters[::-1]:
            runs.setdefault(w, []).append(timed(w))
        out["cluster_ms"] = {w: sum(v) / 2 for w, v in runs.items()}
    for walk in walks:
        out[f"{walk}_timeline"] = walk_profile(name, walk, tables, prep, bfc)
    return out


def query_study(name, tables, prep, bfc, walks=WALKS) -> dict:
    """Work counts and bounds (`anyhit_walk_torch.work_counts`) and the
    walks (`walk_ab`) on one kept closest-hit query."""
    k = ci.KERNELS[name]
    plain_fn = (ci.intersect_fused_plain
                if isinstance(tables, ci.FusedTables) else ci.intersect_plain)
    ref = plain_fn(tables, prep, anyhit=False, backface_culling=bfc,
                   root_filter=k.root_filter, collect_stats=k.collect_stats)
    return {"rays": prep.n_rays, "tiles": prep.n_tiles,
            **aw.work_counts(name, tables, prep, bfc),
            **walk_ab(name, tables, prep, bfc, ref, walks=walks)}


def timed_closest(walk: str, records: list, keep: dict | None = None):
    """`anyhit_walk_torch.timed_queries` of the single-mesh closest hits,
    each on walk `walk`."""
    return aw.timed_queries(
        lambda name, tables, prep, bfc: run_walk(name, walk, tables, prep,
                                                 bfc),
        records, keep, anyhit=False)


def frame_closest_ms(scene, walk: str, keep: dict | None = None) -> dict:
    """One bouncing frame with every closest hit on walk `walk`
    (`anyhit_walk_torch.frame_kernel_ms`: device time per bounce from
    torch.profiler, CUDA events around each query)."""
    return aw.frame_kernel_ms(
        scene, walk, lambda records: timed_closest(walk, records, keep),
        walk_kernel_re(walk), ("closest",))


def bouncing_keep(n_blocks: int) -> dict:
    """Call indices of the kept bouncing closest hits (one per ray block
    and bounce): bounce 0's middle block, and every query of bounce 2
    (the heaviest is kept, `heaviest_bounce2`)."""
    keep = {n_blocks // 2: "bounce0"}
    for i in range(n_blocks):
        keep[2 * n_blocks + i] = f"bounce2_block{i}"
    return keep


def heaviest_bounce2(kept: dict, n_blocks: int) -> None:
    """Keep, as kept["bounce2"], bounce 2's closest hit with the most live
    (tile, super) pairs, and drop the other bounce-2 ones."""
    i = max(range(n_blocks),
            key=lambda b: int(kept[f"bounce2_block{b}"][1].counts.sum()))
    kept["bounce2"] = kept[f"bounce2_block{i}"]
    for b in range(n_blocks):
        kept.pop(f"bounce2_block{b}")


def kept_closest(scene, block: int) -> tuple:
    """The (tables, prepared query) of ray block `block`'s closest hit of
    one forward render (single-mesh or fused)."""
    from rendering_tpu_torch.render.pipeline import render_scene

    kept: dict = {}
    saved = ci.run_query, ci.run_fused_query
    seen = [0]

    def wrap(real):
        def query(tables, prep, *, anyhit, backface_culling, **kw):
            if not anyhit:
                if seen[0] == block:
                    kept["q"] = (tables, prep)
                seen[0] += 1
            return real(tables, prep, anyhit=anyhit,
                        backface_culling=backface_culling, **kw)
        return query

    ci.run_query, ci.run_fused_query = map(wrap, saved)
    try:
        with torch.no_grad():
            render_scene(scene)
    finally:
        ci.run_query, ci.run_fused_query = saved
    return kept["q"]


# ---- SASS ------------------------------------------------------------------


def kernel_name(mangled: str) -> str:
    """`identifier<template args>` of a mangled kernel name
    (fma_chain_kernel<1,6>): the identifier is the one ending in _kernel
    behind its length, which may follow other digits (an anonymous
    namespace's hash), so each tail of a digit run is tried."""
    for d in re.finditer(r"\d+", mangled):
        digits = d.group()
        for i in range(len(digits)):
            ident = mangled[d.end():d.end() + int(digits[i:])]
            if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                          ident):
                args = re.findall(r"L[bi](\d+)E",
                                  mangled[d.end() + len(ident):])
                return f"{ident}<{','.join(args)}>"
    return mangled


def sass_by_kernel(path: str) -> dict:
    """The SASS of each kernel in a built library (cuobjdump -sass), as
    {name<template args>: [(address, text), ...]}; empty where the
    toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    sass = subprocess.run([exe, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    instrs: dict = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            instrs[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([A-Z@].*)", line)
        if fn is not None and m:
            instrs[fn].append((int(m.group(1), 16), m.group(2)))
    return instrs


def loops_per_pair(instrs: dict) -> dict:
    """Per kernel of `instrs` (`sass_by_kernel`) that tests ray-triangle
    pairs: the innermost loop (a backward branch's range) holding
    MUFU.RCP, the pair test's reciprocal, one a pair; its instructions,
    pairs, and instructions and shared loads (LDS) per pair. Static
    counts: the accept path and the root filter's slab count as if always
    taken."""
    out = {}
    for fn, code in instrs.items():
        loops = []
        for addr, text in code:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                body = [t for a, t in code if lo <= a <= addr]
                rcp = sum(bool(re.search(r"\bMUFU\.RCP\b", t)) for t in body)
                if rcp:
                    lds = sum(bool(re.search(r"\bLDS(\.\S+)?\b", t))
                              for t in body)
                    loops.append((len(body), rcp, lds))
        if loops:
            n, rcp, lds = min(loops)
            out[fn] = {"loop_instructions": n, "pairs": rcp,
                       "per_pair": n / rcp, "lds_per_pair": lds / rcp}
    return out


def pair_loops(path: str) -> dict:
    """`loops_per_pair` of every kernel in a built library."""
    return loops_per_pair(sass_by_kernel(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walks", default=",".join(WALKS),
                    help="comma-separated walks: tile, clusterG, clusterGfF "
                         "(split factor F); default: tile and every cluster "
                         "size")
    ap.add_argument("--frames", default=f"tile,{SHIPPED}",
                    help="the walks whose bouncing frame is profiled")
    args = ap.parse_args(argv)
    walks = tuple(args.walks.split(","))
    frame_walks = tuple(args.frames.split(","))
    for w in walks + frame_walks:
        g, _ = walk_config(w)
        if w != "tile" and (not w.startswith("cluster")
                            or g not in ci.CLUSTER_SIZES):
            raise SystemExit(f"unknown walk {w!r}")
    resolve_device()
    from rendering_tpu_torch.flagship import (
        build_flagship_scene,
        build_multimesh_scene,
        build_tiny_scene,
    )
    from rendering_tpu_torch.utils import nvcc

    card = describe_card()
    print(card)
    path, log = nvcc.build_library(ci.SOURCE)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    sass = pair_loops(path)
    for fn, c in sorted(sass.items()):
        print(f"sass {fn}: {json.dumps(c)}")

    queries = {}
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    queries["flagship"] = ("closest_hit", *kept_closest(scene, n_blocks // 2),
                           scene.static.settings.use_backface_culling)
    mm = build_multimesh_scene(MM_WIDTH, MM_HEIGHT, n_meshes=MM_MESHES,
                               tris_per_mesh=MM_TRIS)
    mm_blocks = -(-MM_WIDTH * MM_HEIGHT // RAY_BLOCK)
    queries["multimesh"] = ("fused_closest_hit",
                            *kept_closest(mm, mm_blocks // 2),
                            mm.static.settings.use_backface_culling)
    del scene, mm
    tiny = build_tiny_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    bfc = tiny.static.settings.use_backface_culling
    frame_closest_ms(tiny, frame_walks[0])  # warm-up: allocator, caches
    frames = []
    for walk in frame_walks:
        kept: dict = dict(bouncing_keep(n_blocks))
        frame = frame_closest_ms(tiny, walk, kept)
        frames.append(frame)
        print(f"bouncing frame on the {walk} walk: {json.dumps(frame)}")
    heaviest_bounce2(kept, n_blocks)
    for key in ("bounce0", "bounce2"):
        queries[f"bouncing_{key}"] = ("closest_hit", *kept[key], bfc)
    studies = {}
    for key, (name, tables, prep, b) in queries.items():
        studies[key] = query_study(name, tables, prep, b, walks=walks)
        print(f"{key}: {json.dumps(studies[key])}")
    print(json.dumps({"card": card, "sass": sass, "frames": frames,
                      "queries": studies}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
