#!/usr/bin/env python3
"""What sets the any hit's time on the card: the shadow queries of the
bouncing frame, their work counts and their tile timelines, for the two
walks of rendering_tpu_torch/csrc/mesh_intersect.cu.

    python3 tools/anyhit_walk_torch.py

The walks: `packed`, the any-hit walk every render path launches
(`anyhit_walk_kernel`: unresolved rays packed into the lowest lanes, a
persistent heaviest-first grid of one CTA per SM, staging overlapped
with compute); `packed_fit`, the same with as many CTAs per SM as fit
(two); and `tile`, the one-CTA-per-tile walk it replaced
(`any_hit_tile_walk*`, kept only to be timed against it).

On build_tiny_scene at 3840x1080 with the 250k procedural mesh (the
bouncing workload of chip_smoke.py, 5 bounces of 32 ray blocks, each
with a point+distant shadow batch of 262,144 rays and a 2x2 area-light
batch of 524,288 rays):

1. renders the frame once per walk (after one warm-up frame) under
   torch.profiler (synchronized
   once, at the frame's end) and prints the any-hit kernels' summed
   device time per bounce, split by batch, beside the frame time, the
   frame's device busy time and idle share; and the same sums from CUDA
   events around each query, which also count the card's waits on the
   host inside a query;
2. keeps three of those queries (bounce 0 point+distant and area of the
   middle block, and bounce 2's point+distant query with the most live
   (tile, super) pairs) and, on each, prints the work from the plain version
   (`pairs` the per-ray cull needs, `union_pairs` the tile's unresolved
   rays evaluate, `warp_pairs` the tile walk issues, `packed_pairs` the
   packed walk issues), the bounds `pairs` and `union_pairs` x 57 f32
   instructions at 33.5e12/s, the tile and packed walks' times in turns
   (`utils.timer.mean_ms`) and the packed walk's with as many CTAs per SM
   as fit, their agreement with the plain version, and their tile
   timelines: the longest and mean tile, the tail from the
   95th-percentile tile end to the last, and the resident CTAs per SM,
   registers and spills.

Prints the card's name and power limit, then one JSON line. Raises
without a CUDA device. chip_smoke.py runs the same measurements through
this module's functions.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rendering_tpu_torch.device import (  # noqa: E402
    describe_card,
    resolve_device,
)
from rendering_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from rendering_tpu_torch.utils.timer import mean_ms  # noqa: E402

WIDTH, HEIGHT, N_TRIS = 3840, 1080, 250_000
RAY_BLOCK = 1 << 17     # integrator.DEFAULT_RAY_BLOCK
REPS = 20
# The bound's rate and instruction count, as chip_smoke.py states them:
# f32 instructions per ray-triangle pair under -fmad=false, each issued
# alone at 132 SMs x 128 lanes x 1.98 GHz.
OPS_PER_PAIR = 57
F32_OPS_RATE = 67e12 / 2
SMS = 132               # H100 SXM
# The walks measured: the tile walk, and the packed walk with its
# persistent grid as it ships (ops/cuda_intersect.py WALK_CTAS_PER_SM) and
# with as many CTAs per SM as fit.
WALKS = ("tile", "packed", "packed_fit")
BATCHES = ("point_distant", "area")


def walk_kernel(name: str, walk: str) -> ci.CudaKernel:
    """The kernel of any-hit variant `name` (ops/cuda_intersect.py
    KERNELS) on walk `walk`: the variant itself for the packed walk, its
    `_tile_walk` twin for the tile walk (the root filter and counters
    kept)."""
    k = ci.KERNELS[name]
    if not k.anyhit:
        raise ValueError(f"{name} is not an any hit")
    if walk != "tile":
        return k
    return ci.KERNELS[ci.variant_name(anyhit=True, fused=False,
                                      root_filter=k.root_filter,
                                      collect_stats=k.collect_stats,
                                      tile_walk=True)]


def geometry(tables):
    """The chunk tables a query walks: fused tables' geometry, or the
    tables themselves."""
    return tables.geo if isinstance(tables, ci.FusedTables) else tables


def run_walk(name, walk, tables, prep, bfc, timing=None):
    """Query `name` on walk `walk` (packed_fit: the packed walk with as
    many CTAs per SM as fit)."""
    grid = ({"ctas_per_sm": 0} if walk == "packed_fit" else {})
    return walk_kernel(name, walk)(geometry(tables), prep,
                                   backface_culling=bfc, timing=timing,
                                   **grid)


@contextlib.contextmanager
def timed_queries(run, records: list, keep: dict | None = None, *,
                  anyhit: bool = True):
    """Send every single-mesh query of one kind (`ci.run_query` with
    `anyhit`) through run(name, tables, prep, bfc), name the variant's,
    with a CUDA event pair around each launch, appended to records in
    call order. keep maps a call index to a key: that call's (tables,
    prepared query) go to keep[key]. Queries of the other kind run as
    they would."""
    real = ci.run_query

    def query(tables, prep, *, anyhit: bool, backface_culling, **kw):
        if anyhit != want:
            return real(tables, prep, anyhit=anyhit,
                        backface_culling=backface_culling, **kw)
        if keep is not None and len(records) in keep:
            keep[keep[len(records)]] = (tables, prep)
        name = ci.variant_name(anyhit=anyhit, fused=False, **{
            k: kw.get(k, False) for k in ("root_filter", "collect_stats",
                                          "two_phase")})
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = run(name, tables, prep, backface_culling)
        ev[1].record()
        records.append(ev)
        return out

    want = anyhit
    ci.run_query = query
    try:
        yield
    finally:
        ci.run_query = real


def timed_anyhits(walk: str, records: list, keep: dict | None = None):
    """`timed_queries` of the any hits, each on walk `walk`."""
    return timed_queries(
        lambda name, tables, prep, bfc: run_walk(name, walk, tables, prep, bfc),
        records, keep)


def bouncing_keep(n_blocks: int) -> dict:
    """Call indices of the kept bouncing queries: two any-hit queries per
    ray block and bounce (point+distant, then area); bounce 0's middle
    block, and every point+distant query of bounce 2 (the heaviest is
    kept, `heaviest_bounce2`)."""
    mid = n_blocks // 2
    keep = {2 * mid: "bounce0_point_distant", 2 * mid + 1: "bounce0_area"}
    for i in range(n_blocks):
        keep[2 * n_blocks * 2 + 2 * i] = f"bounce2_block{i}"
    return keep


def heaviest_bounce2(kept: dict, n_blocks: int) -> None:
    """Keep, as kept["bounce2_point_distant"], bounce 2's point+distant
    query with the most live (tile, super) pairs, and drop the other
    bounce-2 ones."""
    i = max(range(n_blocks),
            key=lambda b: int(kept[f"bounce2_block{b}"][1].counts.sum()))
    kept["bounce2_point_distant"] = kept[f"bounce2_block{i}"]
    for b in range(n_blocks):
        kept.pop(f"bounce2_block{b}")


# Each walk's any-hit kernel, by its name in the profiler's trace.
WALK_KERNEL = {"tile": re.compile(r"mesh_intersect_kernel<true"),
               "packed": re.compile(r"anyhit_walk_kernel"),
               "packed_fit": re.compile(r"anyhit_walk_kernel")}
FRAME_TRIES = 3


def device_kernels(prof) -> list:
    """(name, start ns, duration us) of every kernel a torch.profiler run
    recorded on the card, in start order, from the raw trace (building
    the profiler's event tree costs about a minute a frame)."""
    out = [(e.name(), e.start_ns(), e.duration_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")]
    return sorted(out, key=lambda k: k[1])


def frame_anyhit_ms(scene, walk: str, keep: dict | None = None) -> dict:
    """One bouncing frame with every any-hit query on walk `walk`
    (`frame_kernel_ms`, batches point+distant and area)."""
    return frame_kernel_ms(
        scene, walk, lambda records: timed_anyhits(walk, records, keep),
        WALK_KERNEL[walk], BATCHES)


def frame_kernel_ms(scene, walk: str, timed, kernel_re, batches) -> dict:
    """One bouncing frame with one kind of query routed by
    timed(records) (a `timed_queries` context), under torch.profiler,
    with CUDA events around each query and the frame (synchronized once
    at the end). `batches` names the queries of one ray block and bounce
    in call order; `kernel_re` matches the routed kernel's name in the
    trace. Returns the frame's ms, its device busy time and idle share,
    and per bounce and batch the kernels' summed device time (`*_ms`,
    from the profiler) and the events' (`*_event_ms`, which also hold
    the card's waits on the host between the two events of a query).

    The trace's kernels are matched to the queries in order. On the card
    a profiler session can miss the first kernels it should record and
    receive a previous session's last ones, so each session follows an
    empty one, and a frame is rendered again (up to FRAME_TRIES times,
    `attempts`) until it has one kernel per query and none longer than
    its query's events (`unmatched_kernels`, reported)."""
    best = None
    for attempt in range(1, FRAME_TRIES + 1):
        out = _profiled_frame(scene, walk, timed, kernel_re, batches)
        if out is not None and (best is None or out["unmatched_kernels"]
                                < best["unmatched_kernels"]):
            best = dict(out, attempts=attempt)
        if best is not None and best["unmatched_kernels"] == 0:
            break
    if best is None:
        raise AssertionError(f"no profile of the {walk} walk's frame had "
                             f"one kernel per query")
    return best


def _profiled_frame(scene, walk: str, timed, kernel_re, batches):
    """One try of `frame_kernel_ms`; None when the trace does not hold
    one kernel per routed query."""
    from rendering_tpu_torch.render.pipeline import render_scene

    st = scene.static.settings
    n_blocks = -(-st.width * st.height // RAY_BLOCK)
    records: list = []
    frame = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts):
        torch.cuda.synchronize()  # takes what an earlier session left
    with torch.profiler.profile(activities=acts) as prof:
        with torch.no_grad(), timed(records):
            frame[0].record()
            render_scene(scene)
            frame[1].record()
        torch.cuda.synchronize()
    nb = len(batches)
    per_bounce = nb * n_blocks
    n_bounces = st.max_ray_depth + 1
    kernels = device_kernels(prof)
    launch_ms = [us / 1e3 for name, _, us in kernels
                 if kernel_re.search(name)]
    if len(records) != per_bounce * n_bounces:
        raise AssertionError(f"{len(records)} routed queries, expected "
                             f"{per_bounce * n_bounces}")
    if len(launch_ms) != len(records):
        return None
    event_ms = [e[0].elapsed_time(e[1]) for e in records]
    # A kernel runs between its query's two events: one longer than its
    # events' span was matched to the wrong query.
    unmatched = sum(k > e + 0.01 for k, e in zip(launch_ms, event_ms))
    bounces = []
    for b in range(n_bounces):
        part = slice(b * per_bounce, (b + 1) * per_bounce)
        row = {}
        for i, batch in enumerate(batches):
            row[f"{batch}_ms"] = sum(launch_ms[part][i::nb])
            row[f"{batch}_event_ms"] = sum(event_ms[part][i::nb])
        bounces.append(row)
    frame_ms = frame[0].elapsed_time(frame[1])
    busy_ms = sum(us for _, _, us in kernels) / 1e3
    return {"walk": walk, "frame_ms": frame_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / frame_ms,
            "kernel_ms": sum(launch_ms), "kernel_event_ms": sum(event_ms),
            "launches": len(records), "unmatched_kernels": unmatched,
            "by_bounce": bounces}


def tile_summary(timing: torch.Tensor) -> dict:
    """A launch's tile timeline from its (n_tiles, 3) [start ns, end ns,
    SM] records: the span from the first start to the last end, the
    longest and mean tile, the tail from the 95th-percentile tile end to
    the last one (microseconds), and the SMs that ran a tile. The
    closest walk records above bit 16 of the SM column the distinct SMs
    its cluster ran on: their mean over the tiles and the longest tile's
    (`cluster_sms`, `longest_tile_sms`; 1 without a cluster)."""
    sm_col = timing[:, 2].cpu()
    t = timing.cpu().double()
    start, end = t[:, 0], t[:, 1]
    t0 = float(start.min())
    dur = end - start
    ends = torch.sort(end - t0).values
    p95 = float(ends[min(len(ends) - 1, int(0.95 * len(ends)))])
    spread = torch.clamp_min(sm_col >> 16, 1)
    return {"tiles": int(t.shape[0]), "span_us": float(ends[-1]) / 1e3,
            "longest_us": float(dur.max()) / 1e3,
            "mean_us": float(dur.mean()) / 1e3,
            "tail_us": (float(ends[-1]) - p95) / 1e3,
            "sms": int(torch.unique(sm_col & 0xFFFF).numel()),
            "cluster_sms": float(spread.double().mean()),
            "longest_tile_sms": int(spread[int(torch.argmax(dur))])}


def work_counts(name, tables, prep, bfc) -> dict:
    """The plain version's work counts on a query of variant `name`
    (ops/cuda_intersect.py intersect_plain), the live supers a tile (mean,
    max), and the operations bounds they give: the per-ray pairs and the
    union at the card's rate, the heaviest tile's union at one SM's share
    of it."""
    k = ci.KERNELS[name]
    stats: dict = {}
    fn = (ci.intersect_fused_plain if isinstance(tables, ci.FusedTables)
          else ci.intersect_plain)
    fn(tables, prep, anyhit=k.anyhit, backface_culling=bfc,
       root_filter=k.root_filter, collect_stats=k.collect_stats, stats=stats)
    out = {key: stats[key] for key in ("pairs", "union_pairs", "warp_pairs",
                                       "packed_pairs", "tile_union_max",
                                       "accepts")}
    out["live_supers_mean"] = float(prep.counts.double().mean())
    out["live_supers_max"] = int(prep.counts.max())
    out["pairs_bound_ms"] = stats["pairs"] * OPS_PER_PAIR / F32_OPS_RATE * 1e3
    out["union_bound_ms"] = (stats["union_pairs"] * OPS_PER_PAIR
                             / F32_OPS_RATE * 1e3)
    # The heaviest tile on one SM, at its share of the card's rate.
    out["tile_bound_ms"] = (stats["tile_union_max"] * OPS_PER_PAIR
                            / (F32_OPS_RATE / SMS) * 1e3)
    return out


def walk_profile(name, walk, tables, prep, bfc) -> dict:
    """One walk on a query: its tile timeline (TIMING variant, one launch)
    and its resources."""
    timing = torch.zeros((prep.n_tiles, 3), dtype=torch.int64,
                         device=prep.aux.device)
    run_walk(name, walk, tables, prep, bfc, timing=timing)
    res = ci.resources(walk_kernel(name, walk).name)
    if walk == "packed":
        res["ctas_per_sm"] = min(res["ctas_per_sm"], ci.WALK_CTAS_PER_SM)
    return {**tile_summary(timing), **res}


def same(a, b) -> bool:
    """Bit equality of two output tuples (floats compared as bits)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def walk_ab(name, tables, prep, bfc, ref, reps=REPS) -> dict:
    """An any-hit query on the tile walk and the packed walk in turns
    (tile, packed, packed, tile; `mean_ms` of `reps` launches each; `ms`
    and `tile_walk_ms` the means of two), each first held bit-equal to
    the plain version's outputs `ref` (counters too); the packed walk
    with as many CTAs per SM as fit (`packed_fit_ms`); and each walk's
    tile timeline and resources."""
    for walk in ("tile", "packed"):
        if not same(run_walk(name, walk, tables, prep, bfc), ref):
            raise AssertionError(f"{name} on the {walk} walk disagrees with "
                                 f"its plain version")
    runs: dict = {}
    for walk in ("tile", "packed", "packed", "tile"):
        runs.setdefault(walk, []).append(mean_ms(
            lambda w=walk: run_walk(name, w, tables, prep, bfc), reps=reps))
    out = {"ms": sum(runs["packed"]) / 2,
           "tile_walk_ms": sum(runs["tile"]) / 2,
           "ab_ms": [runs["tile"][0], *runs["packed"], runs["tile"][1]],
           "packed_fit_ms": mean_ms(lambda: run_walk(
               name, "packed_fit", tables, prep, bfc), reps=reps)}
    for walk in ("tile", "packed"):
        out[f"{walk}_timeline"] = walk_profile(name, walk, tables, prep, bfc)
    return out


def query_study(name, tables, prep, bfc) -> dict:
    """Work counts and bounds (`work_counts`) and the walks in turns
    (`walk_ab`) on one kept any-hit query."""
    k = ci.KERNELS[name]
    plain_fn = (ci.intersect_fused_plain
                if isinstance(tables, ci.FusedTables) else ci.intersect_plain)
    ref = plain_fn(tables, prep, anyhit=True, backface_culling=bfc,
                   root_filter=k.root_filter, collect_stats=k.collect_stats)
    return {"rays": prep.n_rays, "tiles": prep.n_tiles,
            **work_counts(name, tables, prep, bfc),
            **walk_ab(name, tables, prep, bfc, ref)}


def main() -> int:
    resolve_device()
    from rendering_tpu_torch.flagship import build_tiny_scene

    from rendering_tpu_torch.utils import nvcc

    card = describe_card()
    print(card)
    _, log = nvcc.build_library(ci.SOURCE)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    scene = build_tiny_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    bfc = scene.static.settings.use_backface_culling
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    frame_anyhit_ms(scene, "packed")  # warm-up: allocator, library, caches
    frames = []
    for walk in WALKS:
        kept: dict = dict(bouncing_keep(n_blocks))
        frame = frame_anyhit_ms(scene, walk, kept)
        frames.append(frame)
        print(f"bouncing frame on the {walk} walk: {json.dumps(frame)}")
    heaviest_bounce2(kept, n_blocks)
    studies = {}
    for key in ("bounce0_point_distant", "bounce0_area",
                "bounce2_point_distant"):
        tables, prep = kept[key]
        studies[key] = query_study("any_hit", tables, prep, bfc)
        print(f"{key}: {json.dumps(studies[key])}")
    print(json.dumps({"card": card, "frames": frames, "queries": studies}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
