#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from rendering_tpu_torch/csrc with nvcc
(one nvcc per source) and its C++ host runtime (csrc/rt_native.cpp: OBJ
load, SAH BVH) with g++, all started together, then drives the port's
paths through the entry points a user calls. It fails at the start if
RTPU_NATIVE=0 is set, and in every `cli.main` phase that loads an OBJ
(10, 12, 13, 24, 26, 27, 31, 37) unless each OBJ load and BVH build went
through the C++ runtime.

The 250k-triangle flagship scene at 3840x1080 (kernels K1 closest hit
and K2 any hit):

1. renders the full frame through `render_scene`, checks that both
   kernels were launched once per ray block, that the frame is finite and
   the mesh is hit, and times the forward pass (1 warm-up, 3 reps); the
   render keeps the two queries (primary rays, batched shadow rays) that
   its middle ray block hands to the kernels;
2. holds each kernel against its plain PyTorch version on 64 sampled
   512-ray tiles of those queries: ids equal, t bit-equal;
3. times each kernel, its plain version and its pre-pass on the whole
   queries, checks the two agree there too, and computes each kernel's
   bound;
4. renders at 384x216 with the kernels and with the plain versions on
   the card and requires equal u8 frames;
5. trains: `diff.inverse.make_train_step` with bench.py's three
   parameters (point light intensity, obj_color, vertices) against a
   seeded target. Counts launches per step, checks the gradients (finite;
   the vertices' nonzero; the other two exactly 0, as jax.grad's are on
   this scene, tests/test_torch_grad.py), requires two steps from the
   same state to be bit-equal, and reports the step time, rays/s
   (W * H / step time, bench.py's key) and the peak device memory.

The 16-mesh scene at 1920x1080 (kernel K5, fused closest hit and fused
any hit over all meshes):

6. renders it through `render_scene`: each K5 entry launched once per
   ray block and no K1/K2 launch; keeps the middle block's queries;
7. holds each K5 entry against its plain version on 64 sampled tiles
   and at the whole query, times both and computes the bound;
8. whole-render u8 parity, kernels vs plain versions, at 384x216;
9. trains the point light's intensity, obj_color and the vertices of
   meshes 4 and 5: launches per step, finite nonzero gradients, two
   steps from the same state bit-equal, step time and peak memory.

The scene-file entry point, `python -m rendering_tpu_torch scene.scene`
(`cli.main`), on t10_shotgun.scene's workload at 3840x1080: the 250k
procedural mesh written as an OBJ, rotated, so clipped by its root box,
with SSAA on (kernels K4, the root filter, and K3, the test counters, as
variants of K1/K2/K5):

10. renders the scene file through the CLI: the BMP decodes to
    3840x1080, the root-filter variants of K1 and K2 launch once per ray
    block of the primary and the SSAA pass and the unfiltered ones never;
    prints the OBJ load, BVH, build and render times, the SSAA mask and
    capacity and the hit fraction; keeps the middle block's queries; then
    runs the scene file through `cli.main` in turns, C++ runtime, Python
    (RTPU_NATIVE=0), Python, C++ runtime, printing each turn's OBJ load,
    BVH, scene build, render and cli.main seconds: the four BMPs
    byte-equal, the two paths' MeshArrays and FlatBVH arrays bit-equal;
11. holds the root-filter kernels against their plain versions on 64
    sampled tiles and on the whole queries, times them and computes
    their bound;
12. renders the scene with collectStatistics=1 through the CLI (the
    statistics block printed), holds the counting kernels against their
    plain versions (counters exactly equal), and times the counting frame
    against the plain frame;
13. whole-render u8 parity at 384x216, kernels vs plain versions, with
    equal counters, on that scene file and on a two-OBJ scene file (one
    mesh clipped, one not: K5 with the root filter and the counters),
    whose own CLI runs at 1920x1080, without and with the counters, give
    the fused variants' launches and numbers.

Reflective and transparent materials, on build_tiny_scene (a plane, the
250k procedural mesh, a glass, a mirror and a diffuse sphere; point,
distant and 2x2 area lights; 5 bounces) at 3840x1080, and the two-phase
shadow query (K6, two launches of the any-hit variant over super ranges
of the tables):

14. renders the frame through `render_scene`: K1 once and K2 twice per
    ray block and bounce, rays_casted equal to the JAX package's count,
    no path dropped; prints each bounce's time and live lanes and the
    peak memory, and times the frame; keeps the middle block's first
    shadow query, three more of its shadow queries (bounce 0's middle
    point+distant and area queries, bounce 2's point+distant one with
    the most live tile-super pairs) and two of its closest-hit queries
    (bounce 0's middle one and bounce 2's with the most live tile-super
    pairs), and holds each of the five to the plain version;
15. whole-render parity at 384x216 with SSAA and the counters on, at
    anyhit_compact_frac 0 and 0.5, kernels vs plain versions; the two
    fracs' frames bit-equal;
16. holds K6 against its plain version (and the single pass) on the kept
    query at fracs 0.25 and 0.5, with and without the counters; times
    each phase, its plain version and bound, and single-pass K2;
17. trains the flagship at fracs 0, 0.25 and 0.5: K6's launches, the
    step time, loss and gradients bit-equal across the fracs;
18. trains the bouncing scene (the point light, obj_color, the mesh
    vertices): launches, two steps bit-equal, step time and peak memory;
19. renders tests/scenes/t01_simple_shapes.scene through `cli.main` and
    holds the BMP to tests/test_golden.py's t01 limits.

The hardware-ceiling probes (ops/microbench.py: K7 the FMA chains, fused
and unfused, and their Triton twin; K8 the grid's per-CTA cost; K9 the
pair test's product in f32 and TF32), through their two tools:

20. runs tools/microbench_vpu_torch.py's measurement (the f32 rates with
    and without FMA, the Triton twin, HBM) with the launch counts at 0
    before it; holds each K7 route against its plain version on one full
    (256, 1024) block at INNER 4096 (bit-equal; the fused routes may
    differ on at most FMA_MAX_MISMATCH of the values);
21. runs tools/microbench_kernel_torch.py's measurement (K8's two forms,
    a CTA per step and the loop of one CTA per SM, at 1, 16384 and 4096
    steps; a one-CTA launch beside x.clone(), y.copy_(x) and torch.neg;
    K9 at the JAX tool's eleven configurations and the four epilogue
    ones at TF32) likewise; holds both K8 forms against a copy, K9's
    packing pass and recurrence against their plain versions (bit for
    bit) and K9 at every configuration against the plain
    version on seeded normal data (highest bit-equal, default within the
    TF32 limits, which must reject an f32 product and inputs truncated to
    TF32); times the plain versions,
    x.clone() (K8's library time) and torch.bmm on the 64 tables (K9's);
    then prints the measured f32 and HBM rates beside F32_OPS_RATE and
    HBM_RATE, and each K1-K6 row's share of its operations bound at both
    rates.

The any-hit walk (csrc/mesh_intersect.cu `anyhit_walk_kernel`, every
any hit of every path):

22. the seeded adversarial shadow queries of ops/shadow_cases.py
    (interleaved pre-resolved lanes, rays leaving the mesh at the scene's
    bias, rays grazing cull-box faces; tests/test_torch_anyhit_walk.py's
    seeds and 2000-triangle mesh) at 262,144 rays: every single-mesh
    any-hit variant against its plain version, 0 mismatches;
23. a transparent 5k mesh beside an opaque 20k one (build_tiny_scene's
    layout, SSAA and the counters on, 384x216): the shadow tables hold
    only the opaque mesh, only the fused kernels with counters launch,
    the kept fused any hit agrees with its plain version, and the whole
    render equals the plain versions' in u8 and counters.

The scene-file default path and the debug passes (t10's workload with the
250k OBJ of phase 10, at 3840x1080):

24. renders the scene file with outputProgress=1 (the scene-file
    default) through `cli.main`, i.e. `render_with_progress`: the BMP
    decodes at full size and is within tests/test_golden.py's default
    limits of phase 10's one-shot BMP; the root-filter kernels launch
    once per ray block of each 128-row strip (34 at 3840x1080) and of the
    SSAA pass, nothing else launches; the real-clock progress lines are
    printed; then the f32 strip frame (a fake clock: one line a strip,
    checked) against the one-shot `render` (differing pixels counted, and
    those outside the JAX strip tolerance), both timed in turns by the
    host clock, and the scene fingerprint's time;
25. `render_resumable` on that scene: bit-equal to the strip frame, each
    checkpoint write (a 49.8 MB accumulator at 3840x1080, under
    build/chip_smoke/) timed; resumed with its last two strips cleared,
    it renders only those and is bit-equal; a checkpoint of the scene
    with the point light at half intensity is rejected with the warning
    and every strip renders again;
26. a t08-like scene file (showNormals=1, SSAA on) through `cli.main`:
    only the closest-hit variant launches, one per ray block; the frame
    is timed; whole-render u8 parity at 384x216, kernels vs plain; then
    the same file with outputProgress=1 (its scene-file default): only
    the closest-hit variant launches, one per ray block of each strip and
    of the SSAA pass, the BMP is within test_golden.py's default limits
    of the one-shot BMP and the f32 strip frame within the JAX strip
    tolerance (atol 2e-6, rtol 3e-4) of `render`;
27. t09-like scene files (showAC=1) through `cli.main` at useAC 1 and 0:
    only the showAC walk's kernel (csrc/bvh_walk.cu, `ac_walk`) launches,
    one per ray block; the plain walk timed on the card on the middle
    131,072-ray block and scaled to the frame's blocks (the measurement
    that decides whether the kernel is needed), against the same scene's
    normal frame; the kernel's counts equal the plain walk's on every
    block of the frame, and its time and bound on the middle block.

The inverse-rendering extras on the flagship (the 250k procedural mesh
with the committed maps) at 3840x1080, through the port's demos
(examples/*_torch.py), `render/animation.py` and `utils/profiling.py`:

28. the texture-paint demo's step (the diffuse map from flat grey, Adam,
    the map clamped): K1 and K2 once per ray block (32 each) and nothing
    else, the map gradient finite, the covered texels counted, two steps
    from the same state bit-equal, the loss falling over 5 steps; the
    step time, rays/s and peak memory; a traced step: the top kernels by
    `op_profile` and the texel gradient's share of the device time (the
    backward of the map gather, the span IndexBackward0); at 384x216 the
    gradient with the kernels bit-equal to the plain versions';
29. the camera demo's pose step (`euler_matrix_j`, the clipped Adam on a
    cosine schedule): launches as in 28, finite nonzero gradients, two
    steps bit-equal, the step time; then central differences against
    autograd on the card on tests/test_grad_camera_reference.py's
    infinite plane at 200x150 (the port's f32 frame mean; eps 0.05 for
    px, pz and 1 degree for rx; rtol 0.08);
30. a turntable of 4 `orbit_cameras` outside the mesh's bounds: K1 and
    K2 once per ray block of each frame, `render_frames` bit-equal to
    single `render`s, `render_frames_pipelined` (depth 2, f32 and u8)
    equal to `render_frames`; ms a frame by the host clock, the pull
    included, sequential and pipelined in turns; again for two frames
    with SSAA on;
31. `cli.main([scene, "--trace-dir", d])` on phase 10's scene file: one
    trace written, `op_profile` rows that include the closest and
    any-hit walk kernels; the top five rows printed.

The scene builders' asset branches, on stand-in OBJ files written under
build/chip_smoke/reference (the reference assets are not in the
repository; every line that prints a time taken on them names them
stand-ins):

32. `build_flagship_scene(3840, 1080, n_tris=250_000,
    real_geometry=True)` over a stand-in shotgun.obj (the procedural mesh
    of 1,539 triangles, the bundled asset's count): C++ load,
    `densify_mesh`, C++ BVH (the densify time and triangle count
    printed); K1 and K2 once per ray block, each held against its plain
    version on 64 tiles and the whole middle block; the frame timed; the
    train step (two steps bit-equal); the frame bit-equal to that of the
    scene built through RTPU_NATIVE=0;
33. `build_multimesh_scene(1920, 1080)` with tris_per_mesh=None over a
    stand-in bunny.obj (5,000 procedural triangles): 16 C++ loads and
    BVH builds; K5 closest and any hit (their root-filter variants where
    a mesh is clipped) once per ray block, each held against its plain
    version on the middle block; the frame and a train step timed.

Several ranks (rendering_tpu_torch/parallel on torch.distributed; each
time printed is labelled with the ranks and cards, "2 ranks on one card"
when they share it, and is no scaling figure):

34. one rank on NCCL in this process (the port's init picks NCCL for a
    rank with a card of its own; all_reduce, all_gather and broadcast on
    the card), then two ranks, each a spawned process (`rank_main`): NCCL
    with a card each when the machine has two, else gloo over CUDA
    tensors on cuda:0; each prints its backend and checks the port's
    all-reduce and all-gather on its card;
35. the ray-sharded flagship (250k, 3840x1080) through
    `render_scene_sharded`: K1 and K2 once per ray block of the rank's
    share on each rank and nothing else, the frame u8-equal to phase 1's
    (the largest f32 difference printed), timed; the sharded train step
    (`make_train_step(mesh=)`): its gradients within rtol 1e-4 (atol
    1e-4 max|g|) of phase 5's, a step from the same state bit-equal, the
    parameters after two steps equal on the ranks (a SHA-1 of their
    bytes); `make_sharded_grad_fn` under both schedules (the bucketed
    all-reduce during backward, one after it) against phase 5's
    gradients scaled to its loss, and against each other at rtol 1e-6;
36. the geometry-sharded 16-mesh scene at 1920x1080, layout (1, 2): K5
    once per ray block on each rank's shard of the fused tables, the
    frame u8-equal to phase 6's, each rank's per-triangle bytes half the
    padded tables' (printed beside the replicated scene's), timed;
37. t10's workload with outputProgress=1 through `cli.main` on the two
    ranks (sharded strips, the root-filter kernels once per ray block of
    the rank's share, only rank 0 printing), then with --geo-shard 2
    (the fused root-filter kernels on each rank's shard): each BMP
    within test_golden.py's default limits of phase 24's.

The intersection oracles without the mesh kernels
(settings.use_pallas_intersect=False, the JAX package's own switch):

38. the flagship (250k, 3840x1080) built with use_pallas_intersect=False:
    above bruteforce_threshold, so every query walks the BVH through the
    `bvh_closest` kernel (csrc/bvh_walk.cu), once per ray block for the
    closest hits and once for the shadow rays, no other kernel; the frame
    timed in turns with the mesh kernels' on the same tensors (kernels,
    walk, walk, kernels; mean of 2 after a warm-up each); the middle
    block's two
    queries through the kernel against the plain walk on the card (ids,
    t, u, v bit-equal, counters equal), the plain walk's time there, the
    kernel's time and bound (its slab and pair tests at F32_OPS_RATE);
    the u8 frame against phase 1's (differing values printed); every
    primary ray's hit against the mesh kernels', each differing one a tie
    (both t bit-equal through ray_triangle_r); a train step with its
    repeat bit-equal and its loss and gradients within rtol 1e-4 (atol
    1e-4 max|g|) of phase 5's;
39. the 16-mesh scene at DENSE_WH (a quarter of phase 6's pixels: the
    direct frame would take ~110 s at 1920x1080) with
    use_pallas_intersect=False: every mesh at or below the threshold,
    so the dense scans, no kernel launched; the frame through the
    bilinear form (use_mxu_intersect) and through the direct scan, timed
    once each, against phase 6's path (K5) at the same size: the direct
    frame u8-equal but at tie rays (each differing pixel's primary ray
    checked), the bilinear one within test_golden.py's default limits;
    the middle block's primary hits through the bilinear form twice under
    deterministic algorithms, bit-equal.

The integrator's index accumulation (csrc/index_accumulate.cu: the
radiance scatter into the frame and the per-object gathers' backward):

40. tests/scenes/t01_simple_shapes.scene at 800x600, the benchmark's
    simpleshapes size: a frame with SSAA and a train step of the light's
    intensity and obj_color, each twice and bit-equal, every call of the
    accumulation recorded (calls a frame and a step); on the frame's
    largest scatter (524,288 lanes x 3) and the step's per-object gather
    backward (131,072 lanes into 5 rows): the kernel bit-equal to its
    plain version, its ms a launch, the plain version's, the library's
    deterministic `index_add` (a yardstick only) and the bound in bytes.

The train step on a transparent mesh (the benchmark's glass250k cell):

41. benchmark/configs/glass250k.json at its full size, 800x600 and the
    250,000-triangle glass mesh, 11 bounces, SSAA off, the cell's three
    parameters: the share of primary rays on the glass, a frame at
    headroom 1 (the paths it drops, against the live children a growing
    queue keeps), then two train steps from the same state (launches by
    kernel, no path dropped, bit-equal, peak memory) and the step's time.
    `python3 chip_smoke.py 41` runs this phase alone.

The pre-pass kernel (csrc/mesh_intersect.cu `prepass_kernel`, every
query's visit tables):

42. the flagship frame's middle ray block (256 tiles x 489 supers), its
    primary and its shadow query: the kernel's torder and counts
    bit-equal to the plain `tile_tables` on the same card inputs; the
    ms a launch of the kernel, of the sort keys' PyTorch ops and of the
    plain version, of `prepare` with each, the bound (tiles x 512 x Cs
    slab tests at PREPASS_SLAB_OPS f32 instructions, or the bytes), and
    whether `prepare` makes a host sync (PyTorch's sync debug mode);
    then the flagship train step with the plain pre-pass and with the
    kernel in turns. Every launch check requires one pre-pass launch
    for each intersection launch. `python3 chip_smoke.py 42` runs this
    phase alone.

Every query a phase holds to its plain version (phases 3, 7, 11, 12, 13,
14, 16, 23) is also timed on its walk (`ms`) beside the plain version
and the bound, and a closest hit is held to it at every cluster size.
Each row carries the work counts of the plain version (pairs,
union_pairs, warp_pairs, packed_pairs, tile_union_max), the union and
heaviest-tile bounds, and the walk's resources (CTAs per SM, resident
clusters, registers, spills). PERF.md section 6 keeps how the walks
were measured against the one-CTA-a-tile walk they replaced.

Each phase prints its duration. Every time comes from
`utils.timer.mean_ms` (CUDA events, the launches queued behind a ~2 ms
spin). Prints the card, a JSON line of the path numbers, a JSON line of
per-kernel numbers, and as its last line {"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero; without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import re
import sys
import time

import torch

from rendering_tpu_torch.device import describe_card
from rendering_tpu_torch.ops.microbench import (
    F32_FLOPS_RATE,
    F32_OPS_RATE,
    HBM_RATE,
)
from rendering_tpu_torch.utils.timer import mean_ms

N_TRIS = 250_000
WIDTH, HEIGHT = 3840, 1080
MM_WIDTH, MM_HEIGHT = 1920, 1080
MM_MESHES, MM_TRIS_PER_MESH = 16, 5000
# The bundled shotgun.obj's triangle count (bench.py): the stand-in's.
SHOTGUN_TRIS = 1539
PARITY_WH = (384, 216)
SAMPLED_TILES = 64
RAY_BLOCK = 1 << 17     # integrator.DEFAULT_RAY_BLOCK
BENCH_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
# Meshes 0-3, the grid's bottom row, sit below the floor plane (centres
# at y = -1.95, the plane at y = -1.2) and get no gradient; 4 and 5 are
# the first two visible ones.
MM_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 4, "v"),
            ("meshes", 5, "v"))
SMS = 132               # H100 SXM: one tile's bound is at 1/SMS of the rate
# f32 instructions per ray-triangle pair in the kernels' inner loop
# (csrc/mesh_intersect.cu): cross products p and q, 2 x (6 mul + 3 sub);
# det, 3 mul + 2 add; tv, 3 sub; u, v and t, 3 x (4 mul + 2 add); u + v,
# 1 add; 7 compares (det, u >= 0, u <= 1, v >= 0, u + v <= 1, t >= 0,
# t < t_best); 1 select (ok ? det : 1); and the IEEE reciprocal 1/det,
# MUFU.RCP plus 3 refinement instructions. Shared-memory loads, branches
# and predicate logic are left out, so the bound stays a lower bound.
OPS_PER_PAIR = 18 + 5 + 3 + 18 + 1 + 7 + 1 + 4
# The root filter's literal slab, per pair Moller-Trumbore accepted below
# the running t (csrc/mesh_intersect.cu reach_hit): per axis 1 compare,
# 2 selects, 2 sub and 2 mul; then 4 compares and 2 compare-selects.
SLAB_OPS = 3 * 7 + 4 + 2 * 2
SOURCE = "rendering_tpu_torch/csrc/mesh_intersect.cu"
TPU_KERNEL = "rendering_tpu/ops/pallas_intersect.py:135"
TPU_FUSED = "rendering_tpu/ops/pallas_intersect.py:1154"
TPU_ROOT_FILTER = "rendering_tpu/ops/pallas_intersect.py:328"
TPU_STATS = "rendering_tpu/ops/pallas_intersect.py:177"
TPU_TWO_PHASE = "rendering_tpu/ops/pallas_intersect.py:954"
# The hardware-ceiling probes (K7-K9) and the TPU kernels they replace.
PROBE_SOURCE = "rendering_tpu_torch/csrc/microbench.cu"
TRITON_SOURCE = "rendering_tpu_torch/ops/microbench_triton.py"
TPU_FMA = "tools/microbench_vpu.py:65"
TPU_GRID = "tools/microbench_kernel.py:61"
TPU_MATMUL = "tools/microbench_kernel.py:127"
# K7's fused variant and its Triton twin should equal the plain version bit
# for bit, as the unfused variant must; at most this share of the values
# may differ (a contraction placed otherwise).
FMA_MAX_MISMATCH = 1e-4
# The bouncing workload: build_tiny_scene's four materials and three
# lights with the 250k procedural mesh, at the flagship's resolution.
TINY_PATHS = (("lights", 0, "intensity"), ("obj_color",), ("meshes", 0, "v"))
FRACS = (0.25, 0.5)     # settings.anyhit_compact_frac of K6's runs
# The adversarial shadow queries: full width, over the mesh of
# tests/test_torch_anyhit_walk.py (the 2000-triangle flagship).
ADVERSARIAL_RAYS = 1 << 18
ADVERSARIAL_TRIS = 2000
# The transparent-mesh scene's opaque and transparent meshes.
TRANSPARENT_SCENE_TRIS = (20_000, 5_000)
# tests/test_golden.py's t01_simple_shapes limits (SCENE_TOL, SCENE_MAD):
# interior u8 fractions off by > 1 and > 8, neighbourhood violations,
# and the mean |diff|. Copied: that file imports the JAX package.
T01_TOL = (0.00045, 0.00040, 0.00005, 0.048)
TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
# The scene-file path: t10_shotgun.scene's options, lights and object with
# the 250k procedural mesh as its OBJ (tests/scenes/t10_shotgun.scene).
SCENE_W, SCENE_H = 3840, 1080
TWO_OBJ_WH = (1920, 1080)
TWO_OBJ_TRIS = (50_000, 20_000)   # the clipped mesh, the unclipped one
MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tests", "assets", "maps")
WORKSPACE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke")
SCENE_FILE = """[options]
width={w}
height={h}
ac_penalty=3
background_color=0.52,0.8,0.92
image_name={name}
enableOutput=1
outputProgress={progress}
collectStatistics={stats}

[light]
type=point
position=0,0,0
color=1,1,1
intensity=1.0

[light]
type=distant
direction=0.3,0,-1
color=1,1,1
intensity=0.2

[object]
type=mesh
pos=-0.1,0,-0.6
size=2,2,2
color=1,1,1
rot=0,100,0
material=phong,0.4,0.1,0.7,10.0
name={obj}
diffuse_map={maps}/shotgun_diffuse.bmp
normal_map={maps}/shotgun_normal.bmp
specular_map={maps}/shotgun_specular.bmp
{extra}
[end]
"""
# The two-OBJ scene's second mesh: unrotated, inside its root box.
SECOND_OBJECT = """
[object]
type=mesh
pos=0.9,0.3,-2.2
size=0.8,0.8,0.8
color=0.3,0.5,0.9
material=diffuse
name={obj}
"""


# The debug scenes: tests/scenes/t08_shownormals.scene and t09_showac.scene
# with the 250k procedural mesh as their OBJ, at the flagship's resolution
# (t08 with SSAA on, the scene-file default, one-shot and with
# outputProgress=1; t09 with useAC 1 and 0).
DEBUG_SCENE = """[options]
width={w}
height={h}
{option}=1
useAC={use_ac}
background_color=0,0,0
image_name={name}
enableOutput=1
outputProgress={progress}

[light]
type=distant
direction=0,-1,0
color=1,1,1
intensity=1

[object]
type=mesh
pos=0,0,-3
size=2,2,2
color=1,1,1
rot=0,160,0
name={obj}

[end]
"""
STRIP_ROWS = 128        # render_with_progress's default strip height
# tests/test_golden.py's DEFAULT_TOL and default mean |diff| limit.
DEFAULT_GOLDEN_TOL = (0.006, 0.005, 0.001, 0.15)
# The showAC walk's slab test (csrc/bvh_walk.cu): per axis 2 selects, 2
# sub and 2 mul; 4 compares for the hit; 2 compare-selects after y.
AC_SLAB_OPS = 3 * 6 + 4 + 2 * 2
AC_SOURCE = "rendering_tpu_torch/csrc/bvh_walk.cu"
# No Pallas kernel: the JAX package's walk is this XLA while loop.
AC_REPLACES = "rendering_tpu/ops/traversal.py:161"
ACCUM_SOURCE = "rendering_tpu_torch/csrc/index_accumulate.cu"
ACCUM_REPLACES = ("rendering_tpu/render/integrator.py:964, XLA's "
                  "scatter-add `.at[:, pix].add`")
ACCUM_WH = (800, 600)    # the benchmark's simpleshapes cells
GLASS_SEED = 3_000_000_019  # phase 41's mesh phase (the benchmark's seed)
MEASURED_HBM_RATE = 2.88e12  # bytes/s, the HBM probe's on an H100
# The inverse-rendering extras (phases 28-31): the demos' defaults.
PAINT_LR = 0.05          # examples/texture_paint_demo_torch.py --lr
PAINT_LOSS_STEPS = 5
POSE_LR = 0.05           # examples/inverse_demo_torch.py --lr
POSE_STEPS = 150         # its --steps: the cosine schedule's length
# The turntable: cameras on a circle outside the flagship mesh's bounds
# (centre (-0.1, 0, -0.6), bumps within 1.08 of it), aimed at its centre.
ORBIT_CENTER = (-0.1, 0.0, -0.6)
ORBIT_RADIUS = 3.0
ORBIT_ELEVATION = 15.0
ORBIT_FRAMES = 4
# tests/test_grad_camera_reference.py's scene (an infinite plane filling
# the frame, camera pitched 50 degrees, point light at x = 0.8) and its FD
# limits. Copied: that file imports the JAX package.
FD_SCENE = """[options]
width=200
height=150
background_color=1,0,1
image_name=fdcam
enableOutput=0
outputProgress=0
position=0,0,0
rotation=50,0,0

[light]
type=point
position=0.8,1,-3
color=1,0.95,0.9
intensity=0.05

[object]
type=plane
pos=0,-2,0
normal=0,1,0
color=0.7,0.75,0.8

[end]
"""
FD_EPS = {"px": 0.05, "pz": 0.05, "rx": 1.0}
FD_RTOL = 0.08
# Several ranks (phases 34-37): two processes, each on its own card when
# the machine has two, else both on cuda:0 (gloo); their files go here.
MD_RANKS = 2
MD_DIR = os.path.join(WORKSPACE, "multidevice")
MD_TIMEOUT_S = 400
# Sharded gradients against the single-device step's: rtol, and atol
# rtol * max|g| (tests/test_torch_parallel.py's limits).
GRAD_RTOL = 1e-4
# The oracles without the mesh kernels (phases 38-39): the rays of
# the middle block's queries that the plain BVH walk runs on (all of
# them: 0.7-0.8 s a query on an H100, PERF.md), and the size of the
# dense 16-mesh frames, a quarter of phase 6's pixels (the direct dense
# frame took 27.7 s at 960x540).
BVH_PLAIN_RAYS = RAY_BLOCK
DENSE_WH = (960, 540)
# No Pallas kernel: the JAX package's closest-hit walk is this XLA loop.
BVH_REPLACES = "rendering_tpu/ops/traversal.py:49"
# No Pallas kernel: the JAX package's pre-pass is this XLA function.
PREPASS_REPLACES = "rendering_tpu/ops/pallas_intersect.py::_tile_tables"
# f32 instructions per slab test of the pre-pass (csrc/mesh_intersect.cu
# cull_live), as the other slab bounds count them.
PREPASS_SLAB_OPS = AC_SLAB_OPS


def flags(ci, name) -> dict:
    """The query flags of kernel variant `name` (ops/cuda_intersect.py
    KERNELS): anyhit, root_filter, collect_stats, and two_phase for a
    phase of K6."""
    k = ci.KERNELS[name]
    kw = dict(anyhit=k.anyhit, root_filter=k.root_filter,
              collect_stats=k.collect_stats)
    return {**kw, "two_phase": True} if k.two_phase else kw


def launch(ci, tables, prep, bfc, **kw):
    """The port's query on card tensors, which launches its kernel:
    `run_fused_query` for fused tables, else `run_query`."""
    run = (ci.run_fused_query if isinstance(tables, ci.FusedTables)
           else ci.run_query)
    return run(tables, prep, backface_culling=bfc, **kw)


def plain(ci, tables, prep, bfc, stats=None, two_phase=False, **kw):
    """The same query through the kernel's plain PyTorch version (a
    phase of K6 is the plain any hit over its super range)."""
    fn = (ci.intersect_fused_plain if isinstance(tables, ci.FusedTables)
          else ci.intersect_plain)
    return fn(tables, prep, backface_culling=bfc, stats=stats, **kw)


@contextlib.contextmanager
def counted(ci, out: dict):
    """Set every kernel's launch count to 0 (the intersection kernels,
    the probes and the showAC walk), run the block, and store the counts
    just after it (synchronized) in `out`."""
    from rendering_tpu_torch.ops import microbench as mb
    from rendering_tpu_torch.ops import traversal

    launchers = {**ci.KERNELS, **mb.KERNELS, **traversal.KERNELS}
    for k in launchers.values():
        k.launches = 0
    yield
    torch.cuda.synchronize()
    out.update({name: k.launches for name, k in launchers.items()})


def same(a, b) -> bool:
    """Bit equality of two output tuples (floats compared as bits)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def sample_tiles(ci, prep, n_tiles: int):
    """The n_tiles evenly spaced 512-ray tiles of a prepared query, with
    their own rows of the visit tables."""
    pick = torch.linspace(0, prep.n_tiles - 1, n_tiles).round().long()
    lanes = (pick[:, None] * ci.RAY_TILE
             + torch.arange(ci.RAY_TILE)[None, :]).reshape(-1)
    pick, lanes = pick.to(prep.aux.device), lanes.to(prep.aux.device)
    counts = prep.counts[pick].contiguous()
    return ci.Prepared(prep.aux[:, lanes].contiguous(),
                       prep.torder[pick].contiguous(), counts, lanes.numel(),
                       *ci.tile_schedule(counts))


def check_parity(ci, name, tables, prep, bfc) -> float:
    """Kernel vs plain version on 64 sampled tiles of a prepared query:
    every integer output (the counters too) equal, t bit-equal. Returns
    the max |t| difference (0 when bit-equal); raises on any mismatch."""
    kw = flags(ci, name)
    prep = sample_tiles(ci, prep, SAMPLED_TILES)
    out_k = launch(ci, tables, prep, bfc, **kw)
    out_p = plain(ci, tables, prep, bfc, **kw)
    torch.cuda.synchronize()
    ids_mis = sum(int((a != b).sum()) for a, b in zip(out_k[1:], out_p[1:]))
    bits_mis = int((out_k[0].view(torch.int32)
                    != out_p[0].view(torch.int32)).sum())
    hit = out_k[1] >= 0
    counters = (f"; counters kernel {[int(x) for x in out_k[-2:]]} plain "
                f"{[int(x) for x in out_p[-2:]]}" if kw["collect_stats"]
                else "")
    print(f"parity {name}: {prep.n_rays} rays in {SAMPLED_TILES} "
          f"tiles, {int(hit.sum())} hit/occluded; mismatches: ids "
          f"{ids_mis}, t bits {bits_mis}{counters}")
    if ids_mis or bits_mis or not bool(hit.any()):
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version (or found nothing)")
    return float((out_k[0] - out_p[0]).abs().max())


def query_bound(ci, tables, prep, kw, stats, out_k) -> dict:
    """The least time the card could take for a prepared query: the
    larger of its bytes (the tables, the prepared rays and visit tables
    read once, the outputs written once) at HBM_RATE and its f32
    operations (the pairs this query's data needs, OPS_PER_PAIR each,
    plus SLAB_OPS per accepted pair with the root filter; `stats` from
    the plain version) at F32_OPS_RATE."""
    fused = isinstance(tables, ci.FusedTables)
    geo = tables.geo if fused else tables
    table_tensors = [geo.tri, geo.cbox] + ([tables.idmap] if fused else [])
    n_in = sum(x.numel() * x.element_size()
               for x in (*table_tensors, prep.aux, prep.torder,
                         prep.counts))
    n_out = sum(x.numel() * x.element_size() for x in out_k)
    bytes_ms = (n_in + n_out) / HBM_RATE * 1e3
    ops = stats["pairs"] * OPS_PER_PAIR
    if kw["root_filter"]:
        ops += stats["accepts"] * SLAB_OPS
    ops_ms = ops / F32_OPS_RATE * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "ops": ops, "bytes_ms": bytes_ms}


def kernel_numbers(ci, name, tables, prep, bfc) -> dict:
    """Times of the kernel, its plain version and the pre-pass on a
    prepared query of the main path, and the kernel's bound from this
    query's work. Also checks the kernel against its plain version on the
    whole query, a closest hit at every cluster size (CLUSTER_SIZES). Its
    row adds the work counts (union_pairs, warp_pairs,
    packed_pairs, tile_union_max), the live supers a tile (mean, max),
    the union and heaviest-tile bounds, and the walk's resources."""
    kw = flags(ci, name)
    stats: dict = {}
    out_p = plain(ci, tables, prep, bfc, stats, **kw)
    out_k = launch(ci, tables, prep, bfc, **kw)
    if not same(out_k, out_p):
        raise AssertionError(f"{name} disagrees with its plain "
                             f"version at the main path's shape")
    if not kw["anyhit"]:
        fused = isinstance(tables, ci.FusedTables)
        for g in ci.CLUSTER_SIZES:
            out_g = ci.KERNELS[name](
                tables.geo if fused else tables, prep, backface_culling=bfc,
                idmap=tables.idmap if fused else None, cluster=g)
            if not same(out_g, out_p):
                raise AssertionError(f"{name} at {g} CTAs a cluster "
                                     f"disagrees with its plain version")
    ms = mean_ms(lambda: launch(ci, tables, prep, bfc, **kw), reps=20)
    plain_ms = mean_ms(lambda: plain(ci, tables, prep, bfc, **kw), reps=1)
    n, aux = prep.n_rays, prep.aux
    geo = tables.geo if isinstance(tables, ci.FusedTables) else tables
    prepass_ms = mean_ms(
        lambda: ci.prepare(geo, aux[0:3, :n], aux[3:6, :n], aux[9, :n]),
        reps=5)
    out = {"rays": prep.n_rays, "pairs": stats["pairs"],
           "accepts": stats["accepts"], "ms": ms, "plain_ms": plain_ms,
           "prepass_ms": prepass_ms,
           **query_bound(ci, tables, prep, kw, stats, out_k)}
    out.update({k: stats[k] for k in ("union_pairs", "warp_pairs",
                                      "packed_pairs", "tile_union_max")})
    out["live_supers_mean"] = float(prep.counts.double().mean())
    out["live_supers_max"] = int(prep.counts.max())
    out["union_bound_ms"] = (stats["union_pairs"] * OPS_PER_PAIR
                             / F32_OPS_RATE * 1e3)
    out["tile_bound_ms"] = (stats["tile_union_max"] * OPS_PER_PAIR
                            / (F32_OPS_RATE / SMS) * 1e3)
    out["resources"] = ci.resources(name)
    return out


@contextlib.contextmanager
def routed_queries(ci, route):
    """Send the port's intersection queries (single-mesh and fused)
    through route(real, tables, prep, backface_culling, **flags) instead
    of `ci.run_query` / `ci.run_fused_query`."""
    saved = ci.run_query, ci.run_fused_query

    def wrap(real):
        def query(tables, prep, *, backface_culling, **kw):
            return route(real, tables, prep, backface_culling, **kw)
        return query

    ci.run_query, ci.run_fused_query = map(wrap, saved)
    try:
        yield
    finally:
        ci.run_query, ci.run_fused_query = saved


def keep_block(ci, block: int, kept: dict):
    """A route that keeps the (tables, prepared query) of ray block
    `block` under kept[anyhit] and runs the real query."""
    seen = {False: 0, True: 0}

    def route(real, tables, prep, backface_culling, **kw):
        anyhit = kw["anyhit"]
        if seen[anyhit] == block:
            kept[anyhit] = (tables, prep)
        seen[anyhit] += 1
        return real(tables, prep, backface_culling=backface_culling, **kw)
    return routed_queries(ci, route)


def plain_queries(ci):
    """Every query through its plain PyTorch version, on the card."""
    def route(real, tables, prep, backface_culling, **kw):
        return plain(ci, tables, prep, backface_culling, **kw)
    return routed_queries(ci, route)


def check_frame(scene, frame3, w, h, what):
    if tuple(frame3.shape) != (3, h, w):
        raise AssertionError(f"{what}: frame shape {tuple(frame3.shape)}")
    if not bool(torch.isfinite(frame3).all()):
        raise AssertionError(f"{what}: frame is not finite")
    bg = scene.bg_color[:, None, None]
    interior = frame3[:, :-1, :-1]
    obj_px = int((interior != bg).any(dim=0).sum())
    print(f"{what}: frame finite; {obj_px} of {interior[0].numel()} pixels "
          f"differ from the background; mean {float(frame3.mean()):.6f}")
    if obj_px < 0.05 * interior[0].numel():
        raise AssertionError(f"{what}: the geometry is not hit")


def check_launches(counts, expect: dict, what):
    """counts of the path's run: each kernel in `expect` launched that
    many times (> 0), every other kernel not at all, except the pre-pass
    kernel (`prepass`), which `expect` leaves out: once for each launch of
    an intersection kernel, as each query prepares once."""
    from rendering_tpu_torch.ops import cuda_intersect as ci

    print(f"{what} launches: {({k: n for k, n in counts.items() if n})}")
    if min(expect.values()) <= 0:
        raise AssertionError(f"{what}: a kernel of the path never launched")
    if "prepass" in counts:
        expect = {**expect, "prepass": sum(
            n for k, n in counts.items() if k in ci.KERNELS and k != "prepass")}
    for name, n in counts.items():
        want = expect.get(name, 0)
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {want}")


def whole_render_parity(ci, build, what):
    """render_scene at PARITY_WH with the kernels and with their plain
    versions on the card: u8 frames and the stats counters equal."""
    from rendering_tpu_torch.render.pipeline import render_scene

    small = build(*PARITY_WH)
    with torch.no_grad():
        u8_k, aux_k = render_scene(small, out_u8=True)
        with plain_queries(ci):
            u8_p, aux_p = render_scene(small, out_u8=True)
    n_diff = int((u8_k != u8_p).sum())
    counts_k = {k: int(v) for k, v in aux_k["stats"].items()}
    counts_p = {k: int(v) for k, v in aux_p["stats"].items()}
    print(f"whole-render parity {what} {PARITY_WH[0]}x{PARITY_WH[1]}: "
          f"{n_diff} differing u8 values; stats kernels {counts_k}, plain "
          f"{counts_p}")
    if n_diff or counts_k != counts_p:
        raise AssertionError(f"{what}: kernel and plain renders disagree")
    return u8_k, counts_k


def train(ci, scene, paths, *, reps: int, zero_ok=(), kept=None):
    """make_train_step on `scene`: one counted step from fresh parameters
    (launches, peak memory, gradients), a second step from the same state
    that must be bit-equal, then `reps` timed steps (host clock,
    synchronized). Gradients must be finite, and nonzero except for the
    keys in `zero_ok`, which must be exactly 0. `kept`, a dict, receives
    the first step's gradients as host arrays."""
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )

    st = scene.static.settings
    gen = torch.Generator(device=scene.device).manual_seed(0)
    target = torch.rand((3, st.height, st.width), generator=gen,
                        device=scene.device)

    def one_step(step):
        init, step_fn = step
        params = extract_params(scene, paths)
        params, _, loss = step_fn(params, init(params), scene, target)
        torch.cuda.synchronize()
        return loss, {k: (v.detach().clone(), v.grad.clone())
                      for k, v in params.items()}

    step = make_train_step(paths)
    counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with counted(ci, counts):
        loss, out = one_step(step)
    peak = torch.cuda.max_memory_allocated()
    grads = {}
    for k, (_, g) in out.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient of {k} is not finite")
        grads[k] = float(g.abs().sum())
        if (k in zero_ok) != (grads[k] == 0.0):
            raise AssertionError(f"gradient of {k}: sum |g| = {grads[k]}")
    print(f"step loss {float(loss):.8f}; sum |grad| {grads}; peak "
          f"{peak / 2**30:.3f} GiB")
    if kept is not None:
        kept.update({k: g.cpu().numpy() for k, (_, g) in out.items()})
    result = {"launches": counts, "loss": float(loss), "grad_abs_sum": grads,
              "peak_bytes": peak}
    loss2, out2 = one_step(step)
    equal = torch.equal(loss, loss2) and all(
        torch.equal(out[k][0], out2[k][0])
        and torch.equal(out[k][1], out2[k][1]) for k in out)
    print(f"two steps from the same state bit-equal: {equal}")
    if not equal:
        raise AssertionError("repeat train steps differ")
    result["repeat_bit_equal"] = equal

    init, step_fn = step
    params = extract_params(scene, paths)
    state = init(params)
    params, state, _ = step_fn(params, state, scene, target)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        params, state, _ = step_fn(params, state, scene, target)
    torch.cuda.synchronize()
    result["step_ms"] = (time.perf_counter() - t0) / reps * 1e3
    result["rays_per_s"] = st.width * st.height / result["step_ms"] * 1e3
    return result


@contextlib.contextmanager
def recorded(module, attr: str, calls: list):
    """Wrap module.attr so that every call appends {"args", "kwargs",
    "result", "s"} (host seconds, synchronized) to calls."""
    real = getattr(module, attr)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append({"args": args, "kwargs": kwargs, "result": out,
                      "s": time.perf_counter() - t0})
        return out

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def native_env(flag: str):
    """RTPU_NATIVE=flag within the block ("0": the Python loader and
    builder), as it was after."""
    saved = os.environ.get("RTPU_NATIVE")
    os.environ["RTPU_NATIVE"] = flag
    try:
        yield
    finally:
        if saved is None:
            del os.environ["RTPU_NATIVE"]
        else:
            os.environ["RTPU_NATIVE"] = saved


@contextlib.contextmanager
def native_path(what: str, native_on: bool = True):
    """Records, within the block, the calls of the port's C++ loader and
    builder (`native.load_obj_native`, `native.build_bvh_native`) and of
    the Python ones (`recorded`), and yields a dict that holds, after the
    block, the OBJ loads and BVH builds and their host seconds. Fails
    unless every OBJ load and every BVH build went through the C++ runtime
    and none through Python (native_on), or, with native_on False, every
    one through Python. Each mesh of these scenes comes from an OBJ, so
    the builds must equal the loads in number."""
    from rendering_tpu_torch import native
    from rendering_tpu_torch.accel import bvh
    from rendering_tpu_torch.models import objloader

    calls = {k: [] for k in ("obj", "bvh", "obj_python", "bvh_python")}
    out: dict = {}
    with contextlib.ExitStack() as stack:
        for key, module, attr in (
                ("obj", native, "load_obj_native"),
                ("bvh", native, "build_bvh_native"),
                ("obj_python", objloader, "load_obj_python"),
                ("bvh_python", bvh, "build_bvh_python")):
            stack.enter_context(recorded(module, attr, calls[key]))
        yield out
    ran = {k: [c["result"] is not None for c in v] for k, v in calls.items()}
    n = len(ran["obj"])
    want = [native_on] * n
    ok = (n > 0 and ran["obj"] == want and ran["bvh"] == want
          and ran["obj_python"] == ran["bvh_python"] == [True] * (
              0 if native_on else n))
    out.update(loads=n, native=native_on,
               obj_s=[c["s"] for c in calls["obj" if native_on
                                             else "obj_python"]],
               bvh_s=[c["s"] for c in calls["bvh" if native_on
                                             else "bvh_python"]])
    print(f"{what}: {n} OBJ loads and {len(ran['bvh'])} BVH builds, "
          f"{'C++ runtime' if native_on else 'Python (RTPU_NATIVE=0)'}: "
          f"{ok} (native results {ran['obj']}, {ran['bvh']}; Python calls "
          f"{len(ran['obj_python'])}, {len(ran['bvh_python'])})")
    if not ok:
        raise AssertionError(f"{what}: an OBJ load or BVH build did not go "
                             f"through the {'C++' if native_on else 'Python'}"
                             f" path")


@contextlib.contextmanager
def reference_dir(path: str):
    """flagship.REFERENCE_DIR set to `path` within the block."""
    from rendering_tpu_torch import flagship

    saved = flagship.REFERENCE_DIR
    flagship.REFERENCE_DIR = path
    try:
        yield
    finally:
        flagship.REFERENCE_DIR = saved


class Laps:
    """Prints the duration of each phase as it ends (host clock,
    synchronized)."""

    def __init__(self, prefix: str = ""):
        self.t = time.perf_counter()
        self.laps: dict = {}
        self.prefix = prefix

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.laps[name] = now - self.t
        print(f"{self.prefix}phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


@contextlib.contextmanager
def kept_call(module, attr: str, index: int, out: dict):
    """Wrap module.attr so that its call number `index` (from 0) leaves
    its arguments in out["args"] and out["kwargs"]."""
    real = getattr(module, attr)
    seen = [0]

    def wrapper(*args, **kwargs):
        if seen[0] == index:
            out.update(args=args, kwargs=kwargs)
        seen[0] += 1
        return real(*args, **kwargs)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def timed_bounces(it, out: list):
    """Wrap the integrator's `_bounce` (one castRay level of the whole
    queue): each call appends its host seconds (synchronized) and the
    queue's live and total lanes to out."""
    real = it._bounce

    def wrapper(scene, queue, *args, **kwargs):
        torch.cuda.synchronize()
        live = int((queue.weight > scene.static.settings.min_weight).sum())
        t0 = time.perf_counter()
        result = real(scene, queue, *args, **kwargs)
        torch.cuda.synchronize()
        out.append({"s": time.perf_counter() - t0, "live": live,
                    "lanes": queue.weight.numel()})
        return result

    it._bounce = wrapper
    try:
        yield
    finally:
        it._bounce = real


def bouncing_queries(ci, scene, n_blocks: int) -> tuple[dict, dict]:
    """One more forward render of the bouncing scene, keeping the (tables,
    prepared query) of five of its queries. A frame runs, per ray block
    and bounce, one closest hit and two any hits (point+distant, then
    area). Returns the any hits of bounce 0's middle block
    (`bounce0_point_distant`, `bounce0_area`) and bounce 2's
    point+distant query with the most live (tile, super) pairs
    (`bounce2_point_distant`), and the closest hits of bounce 0's middle
    block (`bounce0`) and bounce 2's heaviest (`bounce2`)."""
    from rendering_tpu_torch.render.pipeline import render_scene

    seen = {False: 0, True: 0}
    kept_b: dict = {}
    kept_c: dict = {}
    heaviest = {False: -1, True: -1}
    mid = n_blocks // 2

    def route(real, tables, prep, backface_culling, **kw):
        anyhit = kw["anyhit"]
        bounce, rest = divmod(seen[anyhit], (2 if anyhit else 1) * n_blocks)
        block, batch = divmod(rest, 2) if anyhit else (rest, 0)
        seen[anyhit] += 1
        if bounce == 0 and block == mid:
            if anyhit:
                name = ("bounce0_point_distant", "bounce0_area")[batch]
                kept_b[name] = (tables, prep)
            else:
                kept_c["bounce0"] = (tables, prep)
        elif bounce == 2 and batch == 0:
            live = int(prep.counts.sum())
            if live > heaviest[anyhit]:
                heaviest[anyhit] = live
                if anyhit:
                    kept_b["bounce2_point_distant"] = (tables, prep)
                else:
                    kept_c["bounce2"] = (tables, prep)
        return real(tables, prep, backface_culling=backface_culling, **kw)

    with torch.no_grad(), routed_queries(ci, route):
        render_scene(scene)
    return kept_b, kept_c


def expected_rays(scene, lanes: int) -> int:
    """rays_casted of a bouncing render by the JAX package's count: every
    bounce traces all `lanes` queue lanes, then for each lane one shadow
    ray per point or distant light and samples^2 per area light."""
    st = scene.static
    shadow = sum(1 if kind in ("point", "distant") else n * n
                 for kind, n in zip(st.light_kinds, st.light_samples))
    return (st.settings.max_ray_depth + 1) * lanes * (1 + shadow)


def with_settings(scene, **kw):
    """The scene with its settings changed (same tensors)."""
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, settings=scene.static.settings.replace(**kw)))


def two_phase_numbers(ci, tb, ro3, rd3, t_limit, frac: float, bfc) -> dict:
    """K6 on one shadow query, phase by phase: each phase's kernel time,
    plain time and bound (`kernel_numbers`, over its super range and its
    own pre-pass), the split, how many rays the first phase resolved, and
    the whole call (both pre-passes, the packing, both launches) by CUDA
    events."""
    name = "any_hit_two_phase"
    cs = tb.sbox.shape[0]
    k = ci.two_phase_split(cs, frac)
    part1 = ci.slice_supers(tb, 0, k)
    prep1 = ci.prepare(part1, ro3, rd3, t_limit)
    phase1 = kernel_numbers(ci, name, part1, prep1, bfc)
    _, tri1 = launch(ci, part1, prep1, bfc, **flags(ci, name))
    occ1 = tri1[:ro3.shape[1]] >= 0
    _, ro_p, rd_p, tl_p = ci.two_phase_pack(occ1, ro3, rd3, t_limit)
    part2 = ci.slice_supers(tb, k, cs)
    phase2 = kernel_numbers(ci, name, part2,
                            ci.prepare(part2, ro_p, rd_p, tl_p), bfc)
    call_ms = mean_ms(lambda: ci.any_hit_two_phase(
        tb, ro3, rd3, t_limit, frac=frac, backface_culling=bfc), reps=5)
    phases = (phase1, phase2)
    return {
        "frac": frac, "supers": cs, "split": k,
        "resolved_in_phase1": int(occ1.sum()), "phases": phases,
        "ms": sum(p["ms"] for p in phases),
        "plain_ms": sum(p["plain_ms"] for p in phases),
        "bound_ms": sum(p["bound_ms"] for p in phases),
        "bound_by": ("operations" if all(p["bound_by"] == "operations"
                                         for p in phases) else "bytes"),
        "ops": sum(p["ops"] for p in phases),
        "bytes_ms": sum(p["bytes_ms"] for p in phases),
        "call_ms": call_ms,
    }


def train_target(scene):
    """The seeded random target frame of a train step on `scene`."""
    st = scene.static.settings
    gen = torch.Generator(device=scene.device).manual_seed(0)
    return torch.rand((3, st.height, st.width), generator=gen,
                      device=scene.device)


def _pool3(img, op):
    """3x3 max/min pooling by shifted stacking (tests/test_golden.py)."""
    import numpy as np

    h, w = img.shape[:2]
    padded = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    return op(np.stack([padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)]), axis=0)


def golden_measures(ours, gold):
    """tests/test_golden.py's measures of a u8 frame against its golden,
    the 1-pixel border left out: the fractions of values off by > 1 and
    by > 8, of pixels outside the golden's 3x3 neighbourhood +- 2, and
    the mean |diff|."""
    import numpy as np

    g = gold.astype(np.int16)
    o = ours.astype(np.int16)
    ok = (o <= _pool3(g, np.max) + 2) & (o >= _pool3(g, np.min) - 2)
    inner = np.abs(o - g)[1:-1, 1:-1]
    return (float((inner > 1).mean()), float((inner > 8).mean()),
            float((~ok.all(axis=2))[1:-1, 1:-1].mean()), float(inner.mean()))


def write_scene(path, obj, *, w, h, stats, name, second_obj=None,
                progress=False):
    with open(path, "w") as fh:
        fh.write(SCENE_FILE.format(
            w=w, h=h, stats=int(stats), name=name, obj=obj, maps=MAPS,
            progress=int(progress),
            extra=SECOND_OBJECT.format(obj=second_obj) if second_obj else ""))


def cli_path(ci, scene_path, what, kept: dict, block: int) -> dict:
    """`python -m rendering_tpu_torch scene_path --output <bmp>` as
    `cli.main`, with every kernel's launch count set to 0 just before it
    and read just after. Records the OBJ load, BVH, scene build and render
    times, the SSAA mask size and capacity of each render attempt, and
    the frame's hit fraction from the BMP; requires each OBJ load and BVH
    build to go through the C++ runtime (`native_path`) and each ray
    block of the primary and SSAA passes to launch the path's closest-
    and any-hit kernels once. Keeps the queries of ray block `block` in
    `kept`
    (keep_block)."""
    import numpy as np

    from rendering_tpu_torch import cli
    from rendering_tpu_torch.models import parser
    from rendering_tpu_torch.models import scene as scene_mod
    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.utils.bmp import (
        bmp_to_image,
        load_bmp,
        quantize_reference,
    )

    bmp = scene_path[:-len(".scene")] + ".bmp"
    rec = {k: [] for k in ("obj", "bvh", "build", "render", "primary",
                           "ssaa")}
    counts: dict = {}
    with contextlib.ExitStack() as stack:
        for key, module, attr in (("obj", parser, "load_obj"),
                                  ("bvh", scene_mod, "build_bvh"),
                                  ("build", scene_mod, "build_scene"),
                                  ("render", pipeline, "render_scene"),
                                  ("primary", pipeline, "_primary_pass"),
                                  ("ssaa", pipeline, "_ssaa_pass")):
            stack.enter_context(recorded(module, attr, rec[key]))
        stack.enter_context(keep_block(ci, block, kept))
        nat = stack.enter_context(native_path(f"{what} cli.main"))
        stack.enter_context(counted(ci, counts))
        t0 = time.perf_counter()
        cli.main([scene_path, "--output", bmp])
        total_s = time.perf_counter() - t0
    scene = rec["build"][0]["result"]
    st = scene.static.settings
    w, h = st.width, st.height
    attempts = []
    blocks = 0
    for k, call in enumerate(rec["render"]):
        cap = (call["kwargs"].get("ssaa_capacity")
               or pipeline.default_ssaa_capacity(st))
        masked = int(call["result"][1]["ssaa_masked"])
        attempts.append({"capacity": cap, "masked": masked,
                         "s": call["s"], "primary_s": rec["primary"][k]["s"],
                         "ssaa_s": rec["ssaa"][k]["s"]})
        blocks += math.ceil(w * h / RAY_BLOCK) + math.ceil(4 * cap / RAY_BLOCK)
    image = bmp_to_image(load_bmp(bmp))
    if image.shape != (h, w, 3):
        raise AssertionError(f"{what}: BMP decodes to {image.shape}")
    bg = quantize_reference(np.asarray(st.background_color, np.float32))
    hit_frac = float((image[1:-1, 1:-1] != bg).any(axis=2).mean())
    clipped = [m.clipped_by_root for m in scene.static.meshes]
    fused = scene.fused_itables is not None
    prefix = "fused_" if fused else ""
    suffix = "_rootfilter" + ("_stats" if st.collect_statistics else "")
    check_launches(counts, {f"{prefix}closest_hit{suffix}": blocks,
                            f"{prefix}any_hit{suffix}": blocks},
                   f"{what} cli.main ({blocks} ray blocks)")
    out = {
        "width": w, "height": h,
        "triangles": [m.n_tris for m in scene.static.meshes],
        "clipped": clipped, "total_s": total_s,
        "obj_load_s": [c["s"] for c in rec["obj"]],
        "bvh_s": [c["s"] for c in rec["bvh"]],
        "build_s": rec["build"][0]["s"],
        "renders": attempts, "hit_fraction": hit_frac,
        "launches": {k: n for k, n in counts.items() if n},
        "native": nat,
        "scene": scene, "scene_def": rec["build"][0]["args"][0],
    }
    print(f"{what}: {w}x{h}, {out['triangles']} triangles (clipped "
          f"{clipped}); OBJ load {out['obj_load_s']} s, BVH {out['bvh_s']} s, "
          f"scene build {out['build_s']:.3f} s, renders {attempts}; "
          f"hit fraction {hit_frac:.4f}; cli.main {total_s:.3f} s")
    if hit_frac < 0.05:
        raise AssertionError(f"{what}: the geometry is not hit")
    return out


def path_numbers(run):
    """A CLI run's numbers without its scene objects."""
    return {k: v for k, v in run.items() if k not in ("scene", "scene_def")}


def scene_at(scene_def, w, h):
    """The scene of a recorded SceneDef, rebuilt at w x h on the card."""
    from rendering_tpu_torch.models.scene import build_scene

    sd = dataclasses.replace(scene_def,
                             settings=scene_def.settings.replace(width=w,
                                                                 height=h))
    return build_scene(sd, device="cuda")


def replaces(name: str) -> str:
    """The TPU kernel (file:line) that kernel `name` replaces: a probe of
    tools/microbench_*.py (K7-K9; K7's Triton twin stands beside K7), the
    two-phase any hit (K6), the counters (K3), the root filter (K4), K5
    or K1/K2."""
    if name.startswith("fma_chain"):
        return TPU_FMA
    if name.startswith("grid_overhead"):
        return TPU_GRID
    if name.startswith("pair_"):  # K9 and its packing and recurrence passes
        return TPU_MATMUL
    if "two_phase" in name:
        return TPU_TWO_PHASE
    if "stats" in name:
        return TPU_STATS
    if "rootfilter" in name:
        return TPU_ROOT_FILTER
    return TPU_FUSED if name.startswith("fused") else TPU_KERNEL


@functools.cache
def tool(name: str, folder: str = "tools"):
    """<folder>/<name>.py (tools/ or examples/) as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_mismatch(out, ref) -> tuple[int, float]:
    """Values of two f32 tensors that differ in their bits (NaN against
    NaN counts as equal), and the max |difference| over the values finite
    in both."""
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    both = ~nan_o & ~nan_r
    mis = int((nan_o != nan_r).sum()) + int(
        (out[both].view(torch.int32) != ref[both].view(torch.int32)).sum())
    fin = torch.isfinite(out) & torch.isfinite(ref)
    err = float((out[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    return mis, err


def probe_row(name, source, launches, err, ms, plain_ms, ops_ms, bytes_ms,
              library_ms):
    return {"name": name, "route": "triton" if source == TRITON_SOURCE
            else "cuda", "source": source, "replaces": replaces(name),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms}


def fma_phase(ci, mb, card_line) -> tuple[list, dict]:
    """tools/microbench_vpu_torch.py's measurement (K7 fused and unfused,
    the Triton twin, the HBM probe) with the launch counts at 0 before it;
    then each route at one repeat of the full (256, 1024) block against
    the plain version (the grid repeats the same values), and the plain
    versions' times."""
    vpu_tool = tool("microbench_vpu_torch")
    counts: dict = {}
    with counted(ci, counts):
        raw = vpu_tool.measure("cuda")
    check_launches(counts, {f"fma_chain_{r}": vpu_tool.REPS + 1
                            for r in vpu_tool.ROUTES},
                   "tools/microbench_vpu_torch.py")
    rates = vpu_tool.rates(raw, card_line)
    print(f"microbench_vpu_torch: {json.dumps(rates)}")
    x = torch.linspace(0.0, 1.0, mb.ROWS * mb.LANES, dtype=torch.float32,
                       device="cuda").reshape(mb.ROWS, mb.LANES)
    plain = {f: mb.fma_chain_plain(x, fused=f) for f in (True, False)}
    plain_ms = {f: mean_ms(lambda f=f: mb.fma_chain_plain(x, fused=f),
                           reps=1) for f in (True, False)}
    rows = []
    for route in vpu_tool.ROUTES:
        fused = route != "unfused"
        out = (mb.fma_chain_triton(x, grid=1) if route == "triton"
               else mb.fma_chain(x, grid=1, fused=fused))
        mis, err = chain_mismatch(out, plain[fused])
        limit = 0 if route == "unfused" else FMA_MAX_MISMATCH * x.numel()
        print(f"parity fma_chain_{route}, one (256, 1024) block, INNER "
              f"{mb.INNER}: {mis} of {x.numel()} values differ from the plain "
              f"version (limit {limit:g}); max |diff| over finite values "
              f"{err}; {int((~torch.isfinite(out)).sum())} non-finite")
        if mis > limit:
            raise AssertionError(f"fma_chain_{route} disagrees with its "
                                 f"plain version")
        r = raw["fma"][route]
        # Bound: the FMAs at 33.5e12/s, or unfused twice the instructions.
        ops_ms = r["ops"] / (2 if fused else 1) / F32_OPS_RATE * 1e3
        name = f"fma_chain_{route}"
        rows.append(probe_row(
            name, TRITON_SOURCE if route == "triton" else PROBE_SOURCE,
            counts[name], err, r["ms"], plain_ms[fused], ops_ms,
            2 * x.numel() * 4 / HBM_RATE * 1e3, None))
    return rows, {"rates": rates, "raw": raw}


def pair_inputs(tc, br, k, epilogue, seed):
    """Seeded normal tables and feats (the tools' own data accept no pair)
    and o_init at a K9 configuration, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    coef = torch.randn((64, 4 * tc, k), generator=gen, device="cuda")
    feats = torch.randn((k, br), generator=gen, device="cuda")
    o_init = torch.full((1, br), 3.0e38 if epilogue else 0.0, device="cuda")
    return feats, coef, o_init


def pair_parity(mb, cfg, n_steps, seed) -> float:
    """K9 at one configuration against the plain version on seeded data:
    bit-equal at highest; at default within the TF32 limits, which must
    reject the f32 product and truncated TF32 inputs (checked in every
    run). Returns the max |difference|."""
    tc, br, k, precision, epilogue = cfg
    feats, coef, o_init = pair_inputs(tc, br, k, epilogue, seed)
    kw = dict(tc=tc, n_steps=n_steps, precision=precision, epilogue=epilogue)
    ref = mb.pair_product_plain(feats, coef, o_init, **kw)
    how = dict(n_steps=n_steps, epilogue=epilogue)
    ctl = {}
    if precision == "default":
        f32 = dict(kw, precision="highest")
        controls = {
            "f32 product": mb.pair_product_plain(feats, coef, o_init, **f32),
            "truncated inputs": mb.pair_product_plain(
                mb.truncate_tf32(feats), mb.truncate_tf32(coef), o_init,
                **f32)}
        ctl = {name: mb.tf32_disagreement(c, ref, feats, coef, **how)[0]
               for name, c in controls.items()}
    out = mb.pair_product(feats, coef, o_init, **kw)
    mis, err = chain_mismatch(out, ref)
    what = f"parity {mb.pair_name(precision, epilogue)} tc={tc} br={br} k={k}"
    accepted = ""
    if epilogue:
        accepted = (f"; accepted lanes kernel {int((out < 3.0e38).sum())}"
                    f", plain {int((ref < 3.0e38).sum())} of {br}")
    if precision == "highest":
        print(f"{what}: {mis} values differ (bit-equal required){accepted}")
        if mis:
            raise AssertionError(f"{what}: kernel and plain version disagree")
        return err
    reading, limit = mb.tf32_disagreement(out, ref, feats, coef, **how)
    measure = (f"share of columns outside rtol {mb.TF32_T_RTOL}"
               if epilogue else "max |diff| / (2 max sum |products|)")
    print(f"{what}: {measure} {reading:.3e} (limit {limit:g}); controls "
          + ", ".join(f"{n} {v:.3e}" for n, v in ctl.items()) + accepted)
    if reading > limit:
        raise AssertionError(f"{what}: kernel and plain version disagree")
    for cname, v in ctl.items():
        if v <= limit:
            raise AssertionError(f"{what}: the TF32 limit does not "
                                 f"reject the {cname}")
    return err


def bmm_ms(coef, feats, n_steps, tf32: bool) -> float:
    """K9's product through torch.bmm: one launch over the 64 tables,
    scaled to n_steps steps; TF32 allowed for `default`, then restored."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        rhs = feats.expand(coef.shape[0], *feats.shape)
        ms = mean_ms(lambda: torch.bmm(coef, rhs), reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return ms * n_steps / coef.shape[0]


def kernel_probe_phase(ci, mb, card_line) -> tuple[list, dict]:
    """tools/microbench_kernel_torch.py's measurement (K8's two forms at 1,
    16384 and 4096 steps; the launch probe; K9 at every configuration)
    with the launch counts at 0 before it; then K8 against a copy, the
    packing and recurrence passes and K9 at every configuration against
    their plain versions, and each kernel's numbers at the JAX tool's
    first configuration (tc 256, br 1024, k 13)."""
    ktool = tool("microbench_kernel_torch")
    counts: dict = {}
    with counted(ci, counts):
        raw = ktool.measure("cuda")
    check_launches(counts, ktool.expected_launches(),
                   "tools/microbench_kernel_torch.py")
    summary = ktool.summary(raw, card_line)
    print(f"microbench_kernel_torch: {json.dumps(summary)}")
    launch = summary["launch"]
    print(f"one-CTA launch against x.clone() (device ms): empty "
          f"{launch['empty_ctas_ms']:.5f} (loop form "
          f"{launch['empty_loop_ms']:.5f}), with the copy "
          f"{launch['copy_ctas_ms']:.5f}; x.clone() {launch['clone_ms']:.5f},"
          f" y.copy_(x) {launch['copy__ms']:.5f}, torch.neg "
          f"{launch['torch_neg_ms']:.5f}; host us per call: ctypes "
          f"{launch['host_us_copy_ctas']:.2f}, clone "
          f"{launch['host_us_clone']:.2f}")
    print(f"K8 per further CTA {summary['per_cta_ns']:.4f} ns, per loop step "
          f"{summary['per_step_ns']:.4f} ns")

    x = torch.randn((8, ktool.BR), device="cuda")
    for form in (mb.grid_overhead, mb.grid_overhead_loop):
        for n in ktool.GRID_STEPS:
            if not torch.equal(form(x, n), x):
                raise AssertionError(f"{form.__name__} at {n} steps is no "
                                     f"copy")
    print(f"parity grid_overhead, grid_overhead_loop at {ktool.GRID_STEPS} "
          f"steps: equal to x")
    steps = max(ktool.GRID_STEPS)
    grid_plain = mean_ms(lambda: mb.grid_overhead_plain(x, steps), reps=20)
    clone_ms = mean_ms(lambda: x.clone(), reps=20)
    bytes_ms = ktool.grid_bytes(ktool.BR) / HBM_RATE * 1e3
    rows = [probe_row(name, PROBE_SOURCE, counts[name], 0.0, ms[steps],
                      grid_plain, 0.0, bytes_ms, clone_ms)
            for name, ms in (("grid_overhead", summary["grid_ms"]),
                             ("grid_overhead_loop", summary["grid_loop_ms"]))]

    errs: dict = {}
    for i, cfg in enumerate(ktool.CONFIGS):
        name = mb.pair_name(cfg[3], cfg[4])
        errs[name] = max(errs.get(name, 0.0),
                         pair_parity(mb, cfg, ktool.N_STEPS, seed=i))

    tc, br, k = 256, 1024, 13   # the JAX tool's first configuration
    n_steps = ktool.N_STEPS
    feats, coef, _ = pair_inputs(tc, br, k, False, seed=99)
    packed = mb.pack_tables(coef, tc)
    pack_ref = mb.pack_tables_plain(coef, tc)
    if not torch.equal(packed.view(torch.int32), pack_ref.view(torch.int32)):
        raise AssertionError("pair_pack_tf32 disagrees with its plain version")
    scratch = torch.randn((n_steps, br), device="cuda")
    o0 = torch.randn((1, br), device="cuda")
    rec = mb.pair_recurrence(scratch, o0.clone())
    mis, rec_err = chain_mismatch(rec, mb.pair_recurrence_plain(scratch, o0))
    if mis:
        raise AssertionError("pair_recurrence disagrees with its plain "
                             "version")
    print(f"parity pair_pack_tf32 (tc {tc}, k {k}, 64 tables): bit-equal; "
          f"pair_recurrence ({n_steps} steps x {br}): bit-equal")
    kp = mb.padded_k(k)
    rows.append(probe_row(
        "pair_pack_tf32", PROBE_SOURCE, counts["pair_pack_tf32"], 0.0,
        mean_ms(lambda: mb.pack_tables(coef, tc), reps=20),
        mean_ms(lambda: mb.pack_tables_plain(coef, tc), reps=5), 0.0,
        4 * coef.shape[0] * 4 * tc * (k + kp) / HBM_RATE * 1e3, None))
    rows.append(probe_row(
        "pair_recurrence", PROBE_SOURCE, counts["pair_recurrence"], rec_err,
        mean_ms(lambda: mb.pair_recurrence(scratch, o0.clone()), reps=20),
        mean_ms(lambda: mb.pair_recurrence_plain(scratch, o0), reps=1),
        2 * n_steps * br / F32_OPS_RATE * 1e3,
        4 * (n_steps * br + 2 * br) / HBM_RATE * 1e3, None))

    for precision in mb.PRECISIONS:
        for epilogue in (False, True):
            feats, coef, o_init = ktool.tool_inputs(
                tc=tc, br=br, k=k, epilogue=epilogue, device="cuda")
            kw = dict(tc=tc, n_steps=n_steps, precision=precision,
                      epilogue=epilogue)
            plain_ms = mean_ms(lambda: mb.pair_product_plain(
                feats, coef, o_init, **kw), reps=1)
            lib_ms = bmm_ms(coef, feats, n_steps, precision == "default")
            r = next(r for r in raw["pair"] if (
                r["tc"], r["br"], r["k"], r["precision"], r["epilogue"])
                == (tc, br, k, precision, epilogue))
            name = mb.pair_name(precision, epilogue)
            rows.append(probe_row(
                name, PROBE_SOURCE, counts[name], errs[name], r["ms"],
                plain_ms, r["ops_ms"], r["bytes_ms"], lib_ms))
            print(f"{name}: {r['ms']:.5f} ms; bound {r['bound_ms']:.5f} "
                  f"ms (product {r['product_ms']:.5f}, epilogue "
                  f"{r['epilogue_ms']:.5f}, f32 without FMA "
                  f"{r['nofma_ms']}); plain {plain_ms:.3f} ms; torch.bmm "
                  f"{lib_ms:.3f} ms")
    print("library_ms: torch.bmm over the 64 tables for K9; x.clone() for K8 "
          "(its function; the probe itself measures launch and per-CTA or "
          "per-step cost); none for K7 (no PyTorch call computes an FMA "
          "chain), the packing pass or the recurrence")
    return rows, {"summary": summary}


def ceiling_report(nums: dict, rates: dict, card_line: str) -> dict:
    """The measured rates beside the constants the bounds use, and each
    K1-K6 row's share of its operations bound at both rates."""
    measured = rates["f32_nofma_ops_per_sec"]
    hbm = rates["hbm_bandwidth_gb_per_sec"] * 1e9
    print(f"f32 issue rate without FMA: measured {measured:.6e}/s against "
          f"F32_OPS_RATE {F32_OPS_RATE:.6e}/s ({measured / F32_OPS_RATE:.4f}"
          f"x); with FMA {rates['f32_fma_flops_per_sec']:.6e} FLOP/s against "
          f"{F32_FLOPS_RATE:.6e}; HBM {hbm:.6e} B/s against HBM_RATE "
          f"{HBM_RATE:.6e} ({hbm / HBM_RATE:.4f}x) on {card_line}")
    shares = {}
    for name, n in nums.items():
        sheet = n["ops"] / F32_OPS_RATE * 1e3
        meas = n["ops"] / measured * 1e3
        shares[name] = {"ms": n["ms"], "ops_ms_datasheet": sheet,
                        "ops_ms_measured": meas,
                        "share_datasheet": sheet / n["ms"],
                        "share_measured": meas / n["ms"]}
        print(f"{name}: {n['ms']:.5f} ms; operations bound {sheet:.5f} ms at "
              f"F32_OPS_RATE ({sheet / n['ms']:.2%}), {meas:.5f} ms at the "
              f"measured rate ({meas / n['ms']:.2%})")
    return shares


def adversarial_phase(ci, tb, bfc, bias) -> dict:
    """The seeded adversarial shadow queries of ops/shadow_cases.py at
    ADVERSARIAL_RAYS rays over the tables tb (the seeds and mesh of
    tests/test_torch_anyhit_walk.py, which holds the same queries at
    1536 rays to the Pallas kernel): every single-mesh any-hit variant
    against its plain version, 0 mismatches (ids, t bits, counters)."""
    from rendering_tpu_torch.ops import shadow_cases as sc

    out = {}
    for kind in sc.KINDS:
        ro, rd, tl = (torch.from_numpy(x).cuda() for x in sc.shadow_case(
            tb, kind, ADVERSARIAL_RAYS, sc.SEEDS[kind], bias=bias))
        prep = ci.prepare(tb, ro, rd, tl)
        for name in ("any_hit", "any_hit_stats", "any_hit_rootfilter",
                     "any_hit_rootfilter_stats"):
            ref = plain(ci, tb, prep, bfc, **flags(ci, name))
            got = launch(ci, tb, prep, bfc, **flags(ci, name))
            out[f"{kind} {name}"] = sum(
                int((a.view(torch.int32) != b.view(torch.int32)).sum())
                if a.dtype == torch.float32 else int((a != b).sum())
                for a, b in zip(got, ref))
        occluded = int((ref[1] >= 0).sum())
        print(f"adversarial {kind}: {ADVERSARIAL_RAYS} rays, "
              f"{int((tl < 0).sum())} entering resolved, {occluded} "
              f"occluded; mismatches (ids, t bits, counters) "
              f"{ {k: v for k, v in out.items() if k.startswith(kind)} }")
    if any(out.values()):
        raise AssertionError("the any-hit walk disagrees with its plain "
                             "version on an adversarial query")
    return out


def transparent_mesh_scene(w, h):
    """build_tiny_scene's layout with its glass sphere replaced by a
    transparent procedural mesh beside the opaque one
    (TRANSPARENT_SCENE_TRIS), SSAA and the counters on: two meshes, so
    fused tables, and shadow tables that must leave the transparent mesh
    out."""
    from rendering_tpu_torch.flagship import procedural_mesh
    from rendering_tpu_torch.models.parser import (
        LightDef,
        ObjectDef,
        SceneDef,
    )
    from rendering_tpu_torch.models.scene import build_scene
    from rendering_tpu_torch.models.settings import RenderSettings

    sd = SceneDef(settings=RenderSettings(
        width=w, height=h, max_ray_depth=4, enable_ssaa=True,
        collect_statistics=True, enable_output=False, output_progress=False,
        background_color=(0.2, 0.25, 0.3)))
    sd.lights = [
        LightDef("point", color=(1, 0.9, 0.8), intensity=0.7, pos=(0, 2, -1)),
        LightDef("distant", color=(1, 1, 1), intensity=0.3,
                 dir=(0.2, -1, -0.4)),
        LightDef("area", color=(1, 1, 1), intensity=40.0, pos=(0, 3, -3),
                 i=(1.5, 0, 0), j=(0, 0, 1.5), samples=2),
    ]
    opaque = ObjectDef("mesh", pos=(0.8, 0.1, -3), size=(1.4, 1.4, 1.4),
                       color=(1, 1, 1), material="phong", ambient=0.4,
                       diffuse=0.1, specular=0.7, n_specular=10.0)
    n_opaque, n_glass = TRANSPARENT_SCENE_TRIS
    opaque.mesh = procedural_mesh(n_opaque, pos=(0.8, 0.1, -3),
                                  size=(1.4, 1.4, 1.4))
    glass = ObjectDef("mesh", pos=(-1.0, 0, -2.5), size=(1.2, 1.2, 1.2),
                      color=(1, 1, 1), material="transparent", ior=1.4)
    glass.mesh = procedural_mesh(n_glass, pos=(-1.0, 0, -2.5),
                                 size=(1.2, 1.2, 1.2), seed=3)
    sd.objects = [
        ObjectDef("plane", pos=(0, -1.5, 0), normal=(0, 1, 0),
                  color=(0.85, 0.85, 0.85)),
        opaque, glass,
        ObjectDef("sphere", pos=(-0.2, 0.8, -4), radius=0.8, color=(1, 1, 1),
                  material="reflective"),
        ObjectDef("sphere", pos=(1.8, -0.6, -2.2), radius=0.4,
                  color=(0.9, 0.3, 0.2)),
    ]
    return build_scene(sd, device="cuda")


def transparent_phase(ci) -> dict:
    """A transparent mesh on the card: the shadow tables hold only the
    opaque mesh, the render launches only the fused kernels with the
    counters, the kept fused any-hit query agrees with its plain version
    on both walks (`kernel_numbers`), and the whole render at PARITY_WH
    equals the plain versions' in u8 and counters."""
    from rendering_tpu_torch.render.pipeline import render_scene

    scene = transparent_mesh_scene(*PARITY_WH)
    ft, fts = scene.fused_itables, scene.fused_shadow_itables
    shadow_mids = sorted(int(x) for x in torch.unique(fts.idmap[0]))
    all_mids = sorted(int(x) for x in torch.unique(ft.idmap[0]))
    opaque_supers = -(-math.ceil(TRANSPARENT_SCENE_TRIS[0] / fts.geo.tri_chunk)
                      // ci.SUB_PER_SUPER)
    print(f"transparent mesh scene {PARITY_WH[0]}x{PARITY_WH[1]}: fused "
          f"tables of meshes {all_mids} ({ft.geo.sbox.shape[0]} supers), "
          f"shadow tables of meshes {shadow_mids} ({fts.geo.sbox.shape[0]} "
          f"supers; the opaque mesh alone has {opaque_supers})")
    if (fts is ft or len(all_mids) != 2 or len(shadow_mids) != 1
            or fts.geo.sbox.shape[0] != opaque_supers):
        raise AssertionError("the shadow tables do not leave the transparent "
                             "mesh out")
    kept: dict = {}
    counts: dict = {}
    bfc = scene.static.settings.use_backface_culling
    with torch.no_grad(), keep_block(ci, 0, kept), counted(ci, counts):
        render_scene(scene)
    launched = {k for k, n in counts.items() if n}
    print(f"transparent mesh render launches: "
          f"{ {k: counts[k] for k in sorted(launched)} }")
    if launched != {"fused_closest_hit_stats", "fused_any_hit_stats",
                    "prepass"}:
        raise AssertionError("the transparent mesh scene launched other "
                             "kernels than the fused ones with counters")
    err = check_parity(ci, "fused_any_hit_stats", *kept[True], bfc)
    nums = kernel_numbers(ci, "fused_any_hit_stats", *kept[True], bfc)
    print(f"fused_any_hit_stats (transparent mesh scene): {json.dumps(nums)}")
    _, stats = whole_render_parity(ci, transparent_mesh_scene,
                                    "transparent mesh, SSAA, "
                                    "collectStatistics=1")
    return {"launches": {k: counts[k] for k in launched},
            "shadow_meshes": shadow_mids, "max_abs_err": err,
            "fused_any_hit_stats": nums, "stats": stats}


@contextlib.contextmanager
def logged(module, attr: str, calls: list):
    """Wrap module.attr so that every call appends its kwargs to calls,
    without waiting for the card (the strip renders launch strip k + 1
    before they read strip k)."""
    real = getattr(module, attr)

    def wrapper(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, real)


def run_cli(ci, scene_path, bmp, records=(), logs=()):
    """`python -m rendering_tpu_torch scene_path --output bmp` as
    `cli.main`, with every kernel's launch count set to 0 just before it
    and read just after, its standard output captured (and printed), the
    calls of each (key, module, attr) in `records` recorded (`recorded`:
    synchronized) and in `logs` logged (`logged`: their kwargs), and each
    OBJ load and BVH build required to go through the C++ runtime
    (`native_path`). Returns {"counts", "rec", "out", "total_s",
    "native", "scene", "scene_def", "image"}."""
    from rendering_tpu_torch import cli
    from rendering_tpu_torch.models import scene as scene_mod
    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    rec = {"build": [], **{k: [] for k, _, _ in (*records, *logs)}}
    counts: dict = {}
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(recorded(scene_mod, "build_scene", rec["build"]))
        for key, module, attr in records:
            stack.enter_context(recorded(module, attr, rec[key]))
        for key, module, attr in logs:
            stack.enter_context(logged(module, attr, rec[key]))
        nat = stack.enter_context(native_path(f"{scene_path} cli.main"))
        stack.enter_context(counted(ci, counts))
        stack.enter_context(contextlib.redirect_stdout(buf))
        t0 = time.perf_counter()
        cli.main([scene_path, "--output", bmp])
        total_s = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return {"counts": counts, "rec": rec, "out": buf.getvalue(),
            "total_s": total_s, "native": nat,
            "scene": rec["build"][0]["result"],
            "scene_def": rec["build"][0]["args"][0],
            "image": bmp_to_image(load_bmp(bmp))}


def host_s(fn):
    """Host seconds of fn() with the card synchronized before and after
    (the strip renders wait on the card inside, so events would time the
    host's waits too), and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def render_blocks(calls, w, h) -> int:
    """Ray blocks of the recorded render_scene calls: the primary pass and
    the SSAA pass at each call's capacity."""
    from rendering_tpu_torch.render import pipeline

    blocks = 0
    for call in calls:
        st = call["args"][0].static.settings
        cap = (call["kwargs"].get("ssaa_capacity")
               or pipeline.default_ssaa_capacity(st))
        blocks += math.ceil(w * h / RAY_BLOCK)
        if st.enable_ssaa and not st.show_ac:
            blocks += math.ceil(4 * cap / RAY_BLOCK)
    return blocks


def progress_phase(ci, obj, oneshot_bmp, card_line):
    """Phase 24: t10's workload with outputProgress=1 through `cli.main`
    (the strip renderer): the BMP at full size and within test_golden.py's
    default limits of the one-shot BMP (phase 10); the primary strips'
    root-filter launches, one per ray block of each strip (34 at
    3840x1080 in 128-row strips), and the SSAA pass's; progress lines;
    then the f32 strip frame (fake clock: a line per strip) against the
    one-shot `render`, both timed in turns, and the scene fingerprint's
    time. Returns (numbers, the scene, the f32 strip frame)."""
    import numpy as np

    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    path = os.path.join(WORKSPACE, "shotgun_progress.scene")
    write_scene(path, obj, w=SCENE_W, h=SCENE_H, stats=False,
                name="shotgun_progress", progress=True)
    run = run_cli(ci, path, path[:-len(".scene")] + ".bmp",
                  records=[("ssaa", pipeline, "_ssaa_pass")],
                  logs=[("strip", pipeline, "_render_strip")])
    scene = run["scene"]
    w, h = SCENE_W, SCENE_H
    if run["image"].shape != (h, w, 3):
        raise AssertionError(f"progress BMP decodes to {run['image'].shape}")
    rows = [kw["rows"] for kw in run["rec"]["strip"]]
    strip_blocks = sum(math.ceil(r * w / RAY_BLOCK) for r in rows)
    caps = [c["kwargs"]["capacity"] for c in run["rec"]["ssaa"]]
    ssaa_blocks = sum(math.ceil(4 * cap / RAY_BLOCK) for cap in caps)
    want_strips = -(-h // STRIP_ROWS)
    if len(rows) != want_strips or ((w, h) == (3840, 1080)
                                    and strip_blocks != 34):
        raise AssertionError(f"progress: strips {rows}, {strip_blocks} blocks")
    check_launches(run["counts"],
                   {"closest_hit_rootfilter": strip_blocks + ssaa_blocks,
                    "any_hit_rootfilter": strip_blocks + ssaa_blocks},
                   f"progress cli.main ({strip_blocks} strip blocks + "
                   f"{ssaa_blocks} SSAA blocks)")
    cli_lines = re.findall(r"^ ?\d+%$", run["out"], re.M)
    measures = golden_measures(run["image"],
                               bmp_to_image(load_bmp(oneshot_bmp)))
    print(f"progress cli.main: {want_strips} strips of rows {rows}; SSAA "
          f"capacities {caps}; progress lines {cli_lines} (real clock); "
          f"BMP vs the one-shot BMP: measures {measures} (limits "
          f"{DEFAULT_GOLDEN_TOL}); cli.main {run['total_s']:.3f} s")
    if any(m > t for m, t in zip(measures, DEFAULT_GOLDEN_TOL)):
        raise AssertionError("the progress BMP is outside the one-shot "
                             "BMP's limits")

    clock = iter(range(0, 10**6, 2))
    lines: list = []
    with torch.no_grad():
        t_one, (one, _) = host_s(lambda: pipeline.render(scene))
        t_strip, (strip, aux) = host_s(lambda: pipeline.render_with_progress(
            scene, _now=lambda: float(next(clock)), _print=lines.append))
        t_strip2, _ = host_s(lambda: pipeline.render_with_progress(
            scene, _print=lambda line: None))
        t_one2, _ = host_s(lambda: pipeline.render(scene))
    want_lines = [f"{100.0 * min((k + 1) * STRIP_ROWS, h) / h:2.0f}%"
                  for k in range(want_strips)]
    if lines != want_lines:
        raise AssertionError(f"progress lines {lines}, expected {want_lines}")
    diff = np.abs(strip - one)
    n_px = int((diff > 0).any(axis=2).sum())
    outside = int((diff > 2e-6 + 3e-4 * np.abs(one)).any(axis=2).sum())
    fp_s, fp = host_s(lambda: pipeline._scene_fingerprint(scene))
    out = {"strips": rows, "strip_blocks": strip_blocks,
           "ssaa_blocks": ssaa_blocks, "ssaa_masked": aux["ssaa_masked"],
           "launches": {k: n for k, n in run["counts"].items() if n},
           "cli_s": run["total_s"], "cli_lines": cli_lines,
           "bmp_measures": measures, "f32_pixels_differing": n_px,
           "f32_pixels_outside_strip_tol": outside,
           "f32_max_abs_diff": float(diff.max()),
           "oneshot_s": [t_one, t_one2], "strip_s": [t_strip, t_strip2],
           "strip_over_oneshot": (t_strip + t_strip2) / (t_one + t_one2),
           "fingerprint_s": fp_s}
    print(f"progress frame {w}x{h}: strip frame vs one-shot render, f32 "
          f"pixels differing {n_px} (outside atol 2e-6 rtol 3e-4: "
          f"{outside}), max |diff| {float(diff.max()):.3e}; in turns "
          f"one-shot {t_one:.3f} s, strips {t_strip:.3f}, {t_strip2:.3f}, "
          f"one-shot {t_one2:.3f} (ratio {out['strip_over_oneshot']:.4f}); "
          f"fingerprint {fp} in {fp_s:.4f} s on {card_line}")
    return out, scene, strip


def resumable_phase(scene, strip, card_line) -> dict:
    """Phase 25: `render_resumable` on phase 24's scene: the full run bit
    for bit equal to render_with_progress's f32 frame `strip`, checkpoint
    writes timed; a resume from its checkpoint with the last two strips
    cleared renders only those and ends bit-equal; the checkpoint is
    rejected, with the warning, for the scene with the point light at half
    intensity, which renders every strip afresh."""
    import numpy as np

    from rendering_tpu_torch.diff.checkpoint import (
        load_checkpoint,
        load_checkpoint_meta,
        save_checkpoint,
    )
    from rendering_tpu_torch.render import pipeline

    w, h = SCENE_W, SCENE_H
    ck = os.path.join(WORKSPACE, "resumable.npz")
    saves: list = []
    with recorded(pipeline, "save_checkpoint", saves):
        full_s, (full, _) = host_s(lambda: pipeline.render_resumable(
            scene, ck, resume=False))
    if not np.array_equal(full.view(np.int32), strip.view(np.int32)):
        raise AssertionError("render_resumable differs from "
                             "render_with_progress")
    _s, _p, _o, frame_ck, mask = load_checkpoint(ck, {}, {})
    n = len(mask)
    mask[-2:] = False
    y0 = (n - 2) * STRIP_ROWS
    frame_ck[:, y0 * w:] = 0.0
    save_checkpoint(ck, n - 2, {}, {}, frame=frame_ck, tile_mask=mask,
                    meta=load_checkpoint_meta(ck))
    strips: list = []
    with logged(pipeline, "_render_strip", strips):
        resume_s, (resumed, _) = host_s(lambda: pipeline.render_resumable(
            scene, ck))
    redone = [kw["y0"] for kw in strips]
    if redone != [y0, y0 + STRIP_ROWS]:
        raise AssertionError(f"the resume rendered strips at {redone}")
    if not np.array_equal(resumed.view(np.int32), full.view(np.int32)):
        raise AssertionError("the resumed frame differs from the full run")
    l0 = scene.lights[0]
    changed = dataclasses.replace(scene, lights=(dataclasses.replace(
        l0, intensity=l0.intensity * 0.5),) + tuple(scene.lights[1:]))
    buf = io.StringIO()
    strips.clear()
    with contextlib.redirect_stdout(buf), \
            logged(pipeline, "_render_strip", strips):
        stale_s, _ = host_s(lambda: pipeline.render_resumable(changed, ck))
    # (The frame itself may not change: the point light's falloff
    # saturates at 1 around the camera.)
    if "ignoring checkpoint" not in buf.getvalue() or len(strips) != n:
        raise AssertionError("a changed scene's checkpoint was not rejected")
    os.remove(ck)
    save_s = [c["s"] for c in saves]
    out = {"full_s": full_s, "resume_s": resume_s, "stale_s": stale_s,
           "checkpoint_write_s": save_s,
           "checkpoint_bytes": 3 * w * h * 4, "resumed_strips": redone}
    print(f"resumable {w}x{h}: full run {full_s:.3f} s, bit-equal to the "
          f"progress frame; checkpoint writes of {3 * w * h * 4} bytes "
          f"{[round(x, 4) for x in save_s]} s (mean "
          f"{sum(save_s) / len(save_s):.4f}); resume of strips {redone} "
          f"{resume_s:.3f} s, bit-equal; changed scene rejected, rendered "
          f"afresh in {stale_s:.3f} s on {card_line}")
    return out


def write_debug_scene(key, option, use_ac, obj, progress=False) -> str:
    path = os.path.join(WORKSPACE, f"debug_{key}.scene")
    with open(path, "w") as fh:
        fh.write(DEBUG_SCENE.format(w=SCENE_W, h=SCENE_H, option=option,
                                    use_ac=use_ac, name=f"debug_{key}",
                                    obj=obj, progress=int(progress)))
    return path


def show_normals_phase(ci, obj, card_line) -> dict:
    """Phase 26: a t08-like scene file (showNormals=1, SSAA on) with the
    250k OBJ at 3840x1080 through `cli.main`: only the closest-hit
    variant launches (one per ray block of the primary and SSAA passes);
    the frame is timed; whole-render u8 parity at 384x216, kernels vs
    plain versions. Then the same file with outputProgress=1 (the
    scene-file default: `render_with_progress`'s showNormals strips and
    its SSAA pass): only the closest-hit variant launches, one per ray
    block of each strip and of the SSAA pass; the BMP within
    test_golden.py's default limits of the one-shot BMP, and the f32
    strip frame within JAX's strip tolerance of `render`."""
    import numpy as np

    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    path = write_debug_scene("normals", "showNormals", 1, obj)
    run = run_cli(ci, path, path[:-len(".scene")] + ".bmp",
                  records=[("render", pipeline, "render_scene")])
    scene = run["scene"]
    st = scene.static
    blocks = render_blocks(run["rec"]["render"], SCENE_W, SCENE_H)
    name = "closest_hit" + ("_rootfilter" if st.meshes[0].clipped_by_root
                            else "")
    check_launches(run["counts"], {name: blocks},
                   f"showNormals cli.main ({blocks} ray blocks)")
    image = run["image"]
    lit = float((image[1:-1, 1:-1] != 0).any(axis=2).mean())
    if image.shape != (SCENE_H, SCENE_W, 3) or lit < 0.05:
        raise AssertionError(f"showNormals BMP {image.shape}, {lit:.4f} lit")

    def frame():
        with torch.no_grad():
            pipeline.render_scene(scene)

    frame_ms = mean_ms(frame, reps=2)
    masked = [int(c["result"][1]["ssaa_masked"]) for c in run["rec"]["render"]]
    whole_render_parity(ci, lambda w, h: scene_at(run["scene_def"], w, h),
                        "showNormals, SSAA")
    print(f"showNormals {SCENE_W}x{SCENE_H}: {name} only; SSAA masked "
          f"{masked}; {lit:.4f} of the pixels lit; frame {frame_ms:.3f} ms "
          f"(CUDA events, mean of 2 after 1 warm-up); cli.main "
          f"{run['total_s']:.3f} s on {card_line}")

    path = write_debug_scene("normals_progress", "showNormals", 1, obj,
                             progress=True)
    prog = run_cli(ci, path, path[:-len(".scene")] + ".bmp",
                   records=[("ssaa", pipeline, "_ssaa_pass")],
                   logs=[("strip", pipeline, "_render_strip")])
    rows = [kw["rows"] for kw in prog["rec"]["strip"]]
    strip_blocks = sum(math.ceil(r * SCENE_W / RAY_BLOCK) for r in rows)
    caps = [c["kwargs"]["capacity"] for c in prog["rec"]["ssaa"]]
    ssaa_blocks = sum(math.ceil(4 * cap / RAY_BLOCK) for cap in caps)
    if len(rows) != -(-SCENE_H // STRIP_ROWS):
        raise AssertionError(f"showNormals progress: strips {rows}")
    check_launches(prog["counts"], {name: strip_blocks + ssaa_blocks},
                   f"showNormals progress cli.main ({strip_blocks} strip "
                   f"blocks + {ssaa_blocks} SSAA blocks)")
    measures = golden_measures(prog["image"], image)
    if any(m > t for m, t in zip(measures, DEFAULT_GOLDEN_TOL)):
        raise AssertionError(f"showNormals progress BMP measures {measures}"
                             f" outside {DEFAULT_GOLDEN_TOL}")
    with torch.no_grad():
        one, _ = pipeline.render(prog["scene"])
        strip, _ = pipeline.render_with_progress(prog["scene"],
                                                 _print=lambda line: None)
    diff = np.abs(strip - one)
    n_px = int((diff > 0).any(axis=2).sum())
    outside = int((diff > 2e-6 + 3e-4 * np.abs(one)).any(axis=2).sum())
    print(f"showNormals progress {SCENE_W}x{SCENE_H}: {name} only, "
          f"{strip_blocks} strip blocks + {ssaa_blocks} SSAA blocks; BMP vs "
          f"the one-shot BMP: measures {measures}; f32 strip frame vs "
          f"render: {n_px} pixels differing, {outside} outside atol 2e-6 "
          f"rtol 3e-4; cli.main {prog['total_s']:.3f} s on {card_line}")
    if outside:
        raise AssertionError("the showNormals strip frame is outside the "
                             "strip tolerance of render")
    return {"launches": {k: n for k, n in run["counts"].items() if n},
            "frame_ms": frame_ms, "cli_s": run["total_s"],
            "ssaa_masked": masked, "lit": lit,
            "progress": {"launches": {k: n for k, n in prog["counts"].items()
                                      if n},
                         "strip_blocks": strip_blocks,
                         "ssaa_blocks": ssaa_blocks, "bmp_measures": measures,
                         "f32_pixels_differing": n_px,
                         "f32_pixels_outside_strip_tol": outside,
                         "cli_s": prog["total_s"]}}


def show_ac_phase(ci, obj, card_line):
    """Phase 27: t09-like scene files (showAC=1) with the 250k OBJ at
    3840x1080 through `cli.main`, useAC 1 and 0: the walk's kernel
    launches once per ray block and nothing else does; Step 1, the plain
    walk on the card on the middle 131,072-ray block, scaled to the
    frame's blocks, against the same scene's normal frame; the kernel's
    counts equal the plain walk's on every block of the frame; the
    kernel's time and bound on the middle block. Returns (numbers, the
    kernel row's numbers at useAC 1)."""
    import numpy as np

    from rendering_tpu_torch.ops import traversal
    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.render.raygen import primary_rays

    out, row = {}, None
    n_blocks = math.ceil(SCENE_W * SCENE_H / RAY_BLOCK)
    for use_ac in (1, 0):
        path = write_debug_scene(f"ac{use_ac}", "showAC", use_ac, obj)
        run = run_cli(ci, path, path[:-len(".scene")] + ".bmp")
        check_launches(run["counts"], {"ac_walk": n_blocks},
                       f"showAC useAC={use_ac} cli.main ({n_blocks} blocks)")
        scene = run["scene"]
        m = scene.meshes[0]
        nodes = (m.node_min, m.node_max, m.skip, m.real_flag)
        ro, rd, _ = primary_rays(scene, offset=0.5)
        blocks = [(ro[b:b + RAY_BLOCK].contiguous(),
                   rd[b:b + RAY_BLOCK].contiguous())
                  for b in range(0, ro.shape[0], RAY_BLOCK)]
        mid = n_blocks // 2
        flag = bool(use_ac)
        plain_s, (c_plain, tests) = host_s(
            lambda: traversal.count_ac_nodes_plain(*nodes, *blocks[mid],
                                                   use_ac=flag))
        frame_plain_s, mismatches, err, c_max = 0.0, 0, 0, 0
        for ro_b, rd_b in blocks:
            dt, (want, _) = host_s(lambda: traversal.count_ac_nodes_plain(
                *nodes, ro_b, rd_b, use_ac=flag))
            frame_plain_s += dt
            got = traversal.count_ac_nodes(m, ro_b, rd_b, use_ac=flag)
            mismatches += int((got != want).sum())
            err = max(err, int((got - want).abs().max()))
            c_max = max(c_max, int(want.max()))
        if mismatches or c_max <= 1:
            raise AssertionError(f"showAC useAC={use_ac}: {mismatches} "
                                 f"counts differ from the plain walk (max "
                                 f"|diff| {err}), max {c_max}")
        ms = mean_ms(lambda: traversal.count_ac_nodes(m, *blocks[mid],
                                                      use_ac=flag), reps=5)
        n_rays = blocks[mid][0].shape[0]
        n_nodes = int(m.node_min.shape[0])
        ops_ms = int(tests) * AC_SLAB_OPS / F32_OPS_RATE * 1e3
        # useAC 1 reads the rays and the node arrays and writes a count a
        # ray; useAC 0 only reads real_flag and writes the counts (each
        # block sums all of real_flag again, which the bound does not
        # charge).
        bytes_ms = ((n_rays * (24 + 4) + n_nodes * 32) if use_ac
                    else (n_rays * 4 + n_nodes * 4)) / HBM_RATE * 1e3
        res = {"nodes": n_nodes, "real_nodes": int((m.real_flag > 0).sum()),
               "max_count": c_max, "max_abs_err": err,
               "box_tests_mid_block": int(tests),
               "plain_mid_block_s": plain_s,
               "plain_scaled_frame_s": plain_s * n_blocks,
               "plain_frame_s": frame_plain_s, "kernel_ms": ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "cli_s": run["total_s"],
               "launches": {k: n for k, n in run["counts"].items() if n}}
        if use_ac:
            normal = with_settings(scene, show_ac=False)

            def normal_frame():
                with torch.no_grad():
                    pipeline.render_scene(normal)

            res["normal_frame_ms"] = mean_ms(normal_frame, reps=1)
            res["kernel_needed"] = (res["plain_scaled_frame_s"] * 1e3
                                    > res["normal_frame_ms"])
            row = {"launches": run["counts"]["ac_walk"], "ms": ms,
                   "plain_ms": plain_s * 1e3, "bound_ms": res["bound_ms"],
                   "bound_by": res["bound_by"], "max_abs_err": float(err)}
        out[f"use_ac_{use_ac}"] = res
        print(f"showAC useAC={use_ac} {SCENE_W}x{SCENE_H}: {json.dumps(res)} "
              f"on {card_line}")
    if not out["use_ac_1"]["kernel_needed"]:
        print("showAC: the plain walk scaled to the frame is below the "
              "normal frame: by Step 1 no kernel was needed")
    return out, row


def device_ps_under(logdir: str, op: str) -> float:
    """Device time (ps) of the kernels launched inside the host spans
    whose name contains `op` in the newest trace under `logdir` (e.g.
    "IndexBackward0": the autograd engine's span of that node's backward):
    the runtime launch calls on the span's thread within it, matched to
    their kernels by correlation id."""
    from rendering_tpu_torch.utils.profiling import find_traces

    with open(find_traces(logdir)[-1]) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(e["pid"], e["tid"], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "cpu_op" and op in e["name"]]
    launched = set()
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        for pid, tid, t0, t1 in spans:
            if (e["pid"], e["tid"]) == (pid, tid) and t0 <= e["ts"] <= t1:
                launched.add(e.get("args", {}).get("correlation"))
                break
    return sum(float(e["dur"]) * 1e6 for e in events
               if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched)


def texture_paint_phase(ci, card_line) -> dict:
    """Phase 28: examples/texture_paint_demo_torch.py's step on the
    flagship at 3840x1080 (the diffuse map from flat grey against the
    true map's render, Adam, the map clamped after each step): K1 and K2
    once per ray block and nothing else; the map gradient finite, the
    covered texels (nonzero gradient) counted; two steps from the same
    state bit-equal; the loss falls over PAINT_LOSS_STEPS steps; the step
    time, rays/s and peak memory; one step traced (`utils.profiling`):
    the top kernels by `op_profile` and the share of the step's device
    time that the texel gradient (the backward of the mapsT gather,
    IndexBackward0) takes. Then at 384x216 one step with the kernels and
    one with their plain versions: the map gradients bit-equal."""
    import shutil

    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.render.pipeline import render_scene
    from rendering_tpu_torch.utils.profiling import op_profile, trace

    demo = tool("texture_paint_demo_torch", "examples")
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)

    def stepper(scene):
        with torch.no_grad():
            target = render_scene(scene)[0]
        init_fn, step_fn = demo.make_paint_step(PAINT_LR)

        def fresh():
            params = demo.flat_grey(scene)
            return params, init_fn(params)

        def one_step():
            params, state = fresh()
            params, state, loss = step_fn(params, state, scene, target)
            torch.cuda.synchronize()
            p = params[demo.KEY]
            return loss, p.detach().clone(), p.grad.clone()

        return target, step_fn, fresh, one_step

    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    target, step_fn, fresh, one_step = stepper(scene)
    counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with counted(ci, counts):
        first = one_step()
    peak = torch.cuda.max_memory_allocated()
    check_launches(counts, {"closest_hit": n_blocks, "any_hit": n_blocks},
                   "texture-paint step")
    grad = first[2]
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError("texture paint: the map gradient is not finite")
    covered = demo.covered_texels(grad)
    n_cov = int(covered.sum())
    if n_cov == 0:
        raise AssertionError("texture paint: no texel has a gradient")
    equal = all(torch.equal(a, b) for a, b in zip(first, one_step()))
    print(f"texture-paint step: loss {float(first[0]):.8f}; covered texels "
          f"{n_cov}/{covered.numel()}; sum |grad| "
          f"{float(grad.abs().sum()):.6e}; two steps from the same state "
          f"bit-equal: {equal}; peak {peak / 2**30:.3f} GiB")
    if not equal:
        raise AssertionError("texture paint: repeat steps differ")

    params, state = fresh()
    losses = []
    for _ in range(PAINT_LOSS_STEPS):
        params, state, loss = step_fn(params, state, scene, target)
        losses.append(float(loss))
    print(f"texture-paint losses over {PAINT_LOSS_STEPS} steps: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError("texture paint: the loss does not fall")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        params, state, _ = step_fn(params, state, scene, target)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3

    tdir = os.path.join(WORKSPACE, "trace_paint")
    shutil.rmtree(tdir, ignore_errors=True)
    with trace(tdir):
        step_fn(params, state, scene, target)
    rows = op_profile(tdir, top=1 << 30)
    device_ps = sum(t for _, t in rows)
    texel_ps = device_ps_under(tdir, "IndexBackward0")
    share = texel_ps / device_ps
    print(f"texture-paint step {WIDTH}x{HEIGHT}: {step_ms:.3f} ms (host "
          f"clock, mean of {reps}), {WIDTH * HEIGHT / step_ms * 1e3:.4e} "
          f"rays/s; traced step: device {device_ps / 1e9:.3f} ms, texel "
          f"gradient (IndexBackward0) {texel_ps / 1e9:.3f} ms = "
          f"{100 * share:.2f}% on {card_line}")
    for name, ps in rows[:5]:
        print(f"  op_profile {ps / 1e9:10.3f} ms  {name[:110]}")
    del scene, target, params, state

    small = build_flagship_scene(*PARITY_WH, n_tris=N_TRIS)
    _, _, _, small_step = stepper(small)
    out_k = small_step()
    with plain_queries(ci):
        out_p = small_step()
    same_grad = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    print(f"texture-paint step {PARITY_WH[0]}x{PARITY_WH[1]}: kernels vs "
          f"plain versions, loss, map and gradient bit-equal: {same_grad}")
    if not same_grad:
        raise AssertionError("texture paint: kernel and plain gradients "
                             "differ")
    return {"launches": {k: n for k, n in counts.items() if n},
            "covered_texels": n_cov, "texels": covered.numel(),
            "losses": losses, "step_ms": step_ms,
            "rays_per_s": WIDTH * HEIGHT / step_ms * 1e3,
            "peak_bytes": peak, "repeat_bit_equal": equal,
            "device_ms": device_ps / 1e9, "texel_grad_ms": texel_ps / 1e9,
            "texel_grad_share": share,
            "op_profile_top": [(n, ps / 1e9) for n, ps in rows[:10]],
            "parity_bit_equal": same_grad}


def camera_pose_phase(ci, card_line) -> dict:
    """Phase 29: examples/inverse_demo_torch.py's pose step on the
    flagship at 3840x1080: params {"pos", "angles_deg"} through
    `euler_matrix_j`, the clipped Adam on its cosine schedule, from the
    demo's perturbed start against the true pose's render: K1 and K2 once
    per ray block and nothing else, finite nonzero gradients, two steps
    from the same state bit-equal, the step time. Then central
    differences on the card against autograd on the infinite-plane scene
    at 200x150: mean(clamp(frame, 0, 1)) by the port's own f32 render,
    eps 0.05 for px and pz, 1 degree for rx, rtol FD_RTOL."""
    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.models.scene import load_scene
    from rendering_tpu_torch.models.settings import RenderSettings
    from rendering_tpu_torch.ops.geometry import euler_matrix_j
    from rendering_tpu_torch.render.pipeline import render_scene

    demo = tool("inverse_demo_torch", "examples")
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    with torch.no_grad():
        target = render_scene(scene)[0]

    def fresh():
        params = demo.start_pose(scene, (0.0, 0.0, 0.0))
        init_fn, step_fn = demo.make_pose_step(params, POSE_LR, POSE_STEPS)
        return params, init_fn(params), step_fn

    def one_step():
        params, state, step_fn = fresh()
        params, state, loss = step_fn(params, state, scene, target)
        torch.cuda.synchronize()
        return [loss] + [t for v in params.values()
                         for t in (v.detach().clone(), v.grad.clone())]

    counts: dict = {}
    with counted(ci, counts):
        first = one_step()
    check_launches(counts, {"closest_hit": n_blocks, "any_hit": n_blocks},
                   "camera-pose step")
    grads = {k: first[2 + 2 * i] for i, k in enumerate(("pos", "angles_deg"))}
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            raise AssertionError(f"camera pose: gradient of {k} is {g}")
    equal = all(torch.equal(a, b) for a, b in zip(first, one_step()))
    print(f"camera-pose step: loss {float(first[0]):.8e}; grads "
          f"{ {k: g.tolist() for k, g in grads.items()} }; two steps from "
          f"the same state bit-equal: {equal}")
    if not equal:
        raise AssertionError("camera pose: repeat steps differ")
    params, state, step_fn = fresh()
    step_fn(params, state, scene, target)  # warm-up
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        params, state, loss = step_fn(params, state, scene, target)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"camera-pose step {WIDTH}x{HEIGHT}: {step_ms:.3f} ms (host "
          f"clock, mean of {reps} after 1 warm-up) on {card_line}")
    del scene, target, params, state

    path = os.path.join(WORKSPACE, "fdcam.scene")
    with open(path, "w") as fh:
        fh.write(FD_SCENE)
    plane = load_scene(path, RenderSettings(enable_ssaa=False))
    base_pos = plane.cam_pos.detach().clone()
    base_ang = torch.tensor([50.0, 0.0, 0.0], device=plane.device)

    def mean(pos, ang):
        frame = render_scene(dataclasses.replace(
            plane, cam_pos=pos, cam_rmat=euler_matrix_j(ang)))[0]
        magenta = (frame[0] > 0.99) & (frame[1] < 0.01) & (frame[2] > 0.99)
        if bool(magenta[:-1, :-1].any()):
            raise AssertionError("FD probe: the background entered the frame")
        return torch.mean(torch.clamp(frame, 0.0, 1.0))

    pos = base_pos.clone().requires_grad_(True)
    ang = base_ang.clone().requires_grad_(True)
    mean(pos, ang).backward()
    auto = {"px": float(pos.grad[0]), "pz": float(pos.grad[2]),
            "rx": float(ang.grad[0])}
    fd = {}
    with torch.no_grad():
        for key, (vec, idx) in (("px", ("pos", 0)), ("pz", ("pos", 2)),
                                ("rx", ("ang", 0))):
            eps = FD_EPS[key]
            probes = []
            for sign in (1.0, -1.0):
                p, a = base_pos.clone(), base_ang.clone()
                (p if vec == "pos" else a)[idx] += sign * eps
                probes.append(float(mean(p, a)))
            fd[key] = (probes[0] - probes[1]) / (2 * eps)
    rel = {k: abs(auto[k] - fd[k]) / abs(fd[k]) for k in fd}
    print(f"camera FD on the card, infinite plane {200}x{150}: autograd "
          f"{auto}, central differences {fd}, relative error {rel} (limit "
          f"{FD_RTOL})")
    if any(r > FD_RTOL for r in rel.values()) or min(
            abs(v) for v in fd.values()) < 1e-4:
        raise AssertionError("camera gradients disagree with central "
                             "differences")
    return {"launches": {k: n for k, n in counts.items() if n},
            "step_ms": step_ms, "rays_per_s": WIDTH * HEIGHT / step_ms * 1e3,
            "repeat_bit_equal": equal,
            "grads": {k: g.tolist() for k, g in grads.items()},
            "fd": {"autograd": auto, "central": fd, "rel_err": rel}}


def turntable_phase(ci, card_line) -> dict:
    """Phase 30: ORBIT_FRAMES `orbit_cameras` around the flagship mesh at
    3840x1080 (SSAA off, the flagship's setting): K1 and K2 once per ray
    block of each frame; every `render_frames` frame bit-equal to a
    separate `render` of its camera; `render_frames_pipelined` (depth 2)
    frames equal to `render_frames`' in f32, and in u8 to the f32 frames
    quantized on the host (`quantize_reference`, which the device's u8
    codes equal). Per-frame host time of the sequential and the pipelined
    generator, the pull included, in turns (sequential, pipelined,
    pipelined, sequential); then the same for the first two cameras with
    SSAA on, where the SSAA pass reads its mask size on the host while
    the next frame is queued."""
    import numpy as np

    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.render.animation import (
        orbit_cameras,
        render_frames,
        render_frames_pipelined,
        set_camera,
    )
    from rendering_tpu_torch.render.pipeline import render
    from rendering_tpu_torch.utils.bmp import quantize_reference

    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    cams = orbit_cameras(ORBIT_CENTER, ORBIT_RADIUS, ORBIT_FRAMES,
                         elevation_deg=ORBIT_ELEVATION)
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)

    def same(xs, ys):
        return all(np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8))
                   for a, b in zip(xs, ys))

    def in_turns(sc, cameras, extra=()):
        """Frames and ms a frame of each run: sequential, pipelined,
        the `extra` (key, generator) runs, pipelined, sequential."""
        runs = (("seq", lambda: render_frames(sc, cameras)),
                ("pip", lambda: render_frames_pipelined(sc, cameras)),
                *extra,
                ("pip", lambda: render_frames_pipelined(sc, cameras)),
                ("seq", lambda: render_frames(sc, cameras)))
        frames, times = {}, {}
        for key, gen in runs:
            s, frames[key] = host_s(lambda: [f for f, _ in gen()])
            times.setdefault(key, []).append(s / len(cameras) * 1e3)
        return frames, times

    counts: dict = {}
    with counted(ci, counts):
        seq = [f for f, _ in render_frames(scene, cams)]
    check_launches(counts, {"closest_hit": ORBIT_FRAMES * n_blocks,
                            "any_hit": ORBIT_FRAMES * n_blocks},
                   f"turntable render_frames ({ORBIT_FRAMES} frames)")
    lit = [float((f[:-1, :-1] != f[0, 0]).any(axis=2).mean()) for f in seq]
    single = [render(set_camera(scene, p, rot_deg=r))[0] for p, r in cams]
    frames, times = in_turns(scene, cams, extra=(
        ("pip_u8", lambda: render_frames_pipelined(scene, cams,
                                                   out_u8=True)),))
    same_single = same(seq, single)
    same_pip = same(seq, frames["seq"]) and same(seq, frames["pip"])
    same_u8 = same([quantize_reference(f) for f in seq], frames["pip_u8"])
    print(f"turntable {ORBIT_FRAMES} frames {WIDTH}x{HEIGHT}: lit fraction "
          f"{lit}; render_frames bit-equal to single renders: {same_single}; "
          f"pipelined equal to sequential, f32 {same_pip}, u8 {same_u8}; ms a "
          f"frame by the host clock, pull included, in turns {times} on "
          f"{card_line}")
    if not (same_single and same_pip and same_u8) or min(lit) < 0.05:
        raise AssertionError("turntable: frames differ or miss the mesh")

    ssaa = with_settings(scene, enable_ssaa=True)
    render(set_camera(ssaa, *cams[0]))  # warm-up: the SSAA pass's first run
    frames_ssaa, times_ssaa = in_turns(ssaa, cams[:2])
    same_ssaa = same(frames_ssaa["seq"], frames_ssaa["pip"])
    print(f"turntable with SSAA, 2 frames: pipelined equal to sequential "
          f"{same_ssaa}; ms a frame in turns {times_ssaa} on {card_line}")
    if not same_ssaa:
        raise AssertionError("turntable with SSAA: pipelined frames differ")
    return {"launches": {k: n for k, n in counts.items() if n},
            "frames": ORBIT_FRAMES, "lit_fraction": lit,
            "frame_ms": times, "frame_ms_ssaa": times_ssaa,
            "single_bit_equal": same_single,
            "pipelined_equal": {"f32": same_pip, "u8": same_u8,
                                "ssaa": same_ssaa}}


def trace_phase(ci, scene_path, card_line) -> dict:
    """Phase 31: `cli.main([scene, "--trace-dir", d])` on t10's workload
    (phase 10's scene file, the 250k OBJ): the BMP written, one trace
    written under d, and `op_profile(d)`'s rows include the intersection
    kernels (the root-filter variants of the closest and any-hit walks);
    prints the top five rows."""
    import shutil

    from rendering_tpu_torch import cli
    from rendering_tpu_torch.utils.profiling import find_traces, op_profile

    tdir = os.path.join(WORKSPACE, "trace_cli")
    shutil.rmtree(tdir, ignore_errors=True)
    bmp = os.path.join(WORKSPACE, "traced.bmp")
    counts: dict = {}
    t0 = time.perf_counter()
    with native_path("cli.main --trace-dir"), counted(ci, counts):
        cli.main([scene_path, "--output", bmp, "--trace-dir", tdir])
    total_s = time.perf_counter() - t0
    traces = find_traces(tdir)
    every = op_profile(tdir, top=1 << 30)
    rows = every[:5]
    walks = sorted({n for n, _ in every if "walk_kernel" in n})
    print(f"cli.main --trace-dir: {total_s:.3f} s; {len(traces)} trace(s), "
          f"{[os.path.getsize(t) for t in traces]} bytes; launches "
          f"{ {k: n for k, n in counts.items() if n} }; intersection "
          f"kernels in the trace: {walks} on {card_line}")
    for name, ps in rows:
        print(f"  op_profile {ps / 1e9:10.3f} ms  {name[:110]}")
    if (len(traces) != 1 or not os.path.exists(bmp) or not any(
            "closest_walk_kernel" in n for n in walks) or not any(
            "anyhit_walk_kernel" in n for n in walks)):
        raise AssertionError("--trace-dir: no trace, no BMP, or no "
                             "intersection kernel in the trace")
    return {"launches": {k: n for k, n in counts.items() if n},
            "total_s": total_s, "trace_bytes": os.path.getsize(traces[0]),
            "top5": [(n, ps / 1e9) for n, ps in rows], "walks": walks}


def native_turns(ci, scene_path, card_line) -> dict:
    """Phase 10's turns: t10's workload (`scene_path`) through `cli.main`
    with the C++ runtime, then the Python loader and builder
    (RTPU_NATIVE=0) twice, then the C++ runtime again (native_path checks
    each). Prints each turn's OBJ load, BVH, scene build, render and
    cli.main seconds (host clock, synchronized). Fails unless the four
    BMPs are byte-equal and the C++ and Python paths' MeshArrays and
    FlatBVH arrays are bit-equal on this host."""
    import numpy as np

    from rendering_tpu_torch import cli
    from rendering_tpu_torch.models import parser
    from rendering_tpu_torch.models import scene as scene_mod
    from rendering_tpu_torch.render import pipeline

    turns, bmps, arrays = [], [], {}
    for k, on in enumerate((True, False, False, True)):
        rec = {key: [] for key in ("obj", "bvh", "build", "render")}
        counts: dict = {}
        bmp = os.path.join(WORKSPACE, f"turn{k}.bmp")
        with contextlib.ExitStack() as stack:
            stack.enter_context(native_env("1" if on else "0"))
            for key, module, attr in (("obj", parser, "load_obj"),
                                      ("bvh", scene_mod, "build_bvh"),
                                      ("build", scene_mod, "build_scene"),
                                      ("render", pipeline, "render_scene")):
                stack.enter_context(recorded(module, attr, rec[key]))
            nat = stack.enter_context(native_path(
                f"turn {k} cli.main", native_on=on))
            stack.enter_context(counted(ci, counts))
            t0 = time.perf_counter()
            cli.main([scene_path, "--output", bmp])
            total_s = time.perf_counter() - t0
        with open(bmp, "rb") as fh:
            bmps.append(fh.read())
        if on not in arrays:
            arrays[on] = (rec["obj"][0]["result"], rec["bvh"][0]["result"])
        turn = {"native": on, "obj_load_s": rec["obj"][0]["s"],
                "bvh_s": rec["bvh"][0]["s"], "build_s": rec["build"][0]["s"],
                "render_s": sum(c["s"] for c in rec["render"]),
                "cli_s": total_s,
                "launches": {key: n for key, n in counts.items() if n}}
        turns.append(turn)
        print(f"scene file turn {k} ({'C++ runtime' if on else 'Python'}): "
              f"OBJ load {turn['obj_load_s']:.3f} s, BVH "
              f"{turn['bvh_s']:.3f} s, scene build {turn['build_s']:.3f} s, "
              f"render {turn['render_s']:.3f} s, cli.main "
              f"{total_s:.3f} s on {card_line}")
        del rec, nat

    def bits(x):
        x = np.ascontiguousarray(x)
        return x.dtype, x.shape, x.view(np.uint8).tobytes()

    mesh_equal = all(bits(getattr(arrays[True][0], f)) == bits(
        getattr(arrays[False][0], f)) for f in ("v", "n", "uv", "tangent",
                                                  "bitangent", "root_bounds"))
    bvh_equal = all(
        (bits(a) == bits(b)) if isinstance(a, np.ndarray) else a == b
        for a, b in ((getattr(arrays[True][1], f.name),
                      getattr(arrays[False][1], f.name))
                     for f in dataclasses.fields(arrays[True][1])))
    bmp_equal = all(b == bmps[0] for b in bmps)
    mean = {on: sum(t["cli_s"] for t in turns if t["native"] == on) / 2
            for on in (True, False)}
    print(f"scene file turns: BMPs byte-equal {bmp_equal}; MeshArrays "
          f"bit-equal {mesh_equal}; FlatBVH bit-equal {bvh_equal}; "
          f"cli.main C++ {mean[True]:.3f} s, Python {mean[False]:.3f} s "
          f"(means of 2) on {card_line}")
    if not (bmp_equal and mesh_equal and bvh_equal):
        raise AssertionError("the C++ and Python host paths disagree")
    return {"turns": turns, "bmp_bytes": len(bmps[0])}


def block_parity(ci, name, tables, prep, bfc, what: str) -> dict:
    """`check_parity` on 64 sampled tiles, then the kernel against its
    plain version on the whole kept query (ids equal, t bit-equal), and
    the kernel's time there (mean_ms) beside the plain version's and the
    query's bound (`query_bound`)."""
    err = check_parity(ci, name, tables, prep, bfc)
    kw = flags(ci, name)
    stats: dict = {}
    out_k = launch(ci, tables, prep, bfc, **kw)
    out_p = plain(ci, tables, prep, bfc, stats, **kw)
    mis = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
              if a.dtype == torch.float32 else int((a != b).sum())
              for a, b in zip(out_k, out_p))
    ms = mean_ms(lambda: launch(ci, tables, prep, bfc, **kw), reps=5)
    plain_ms = mean_ms(lambda: plain(ci, tables, prep, bfc, **kw), reps=1)
    bound = query_bound(ci, tables, prep, kw, stats, out_k)
    print(f"parity {name} on the whole block ({what}): {prep.n_rays} rays, "
          f"mismatches {mis}; kernel {ms:.5f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}, "
          f"{stats['pairs']} pairs)")
    if mis:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"the whole block")
    return {"max_abs_err": err, "mismatches": mis, "ms": ms,
            "plain_ms": plain_ms, "rays": prep.n_rays,
            "pairs": stats["pairs"], **bound}


def write_stand_in(name: str, n_tris: int) -> str:
    """A stand-in reference asset: the procedural mesh of n_tris
    triangles written as build/chip_smoke/reference/input/objects/<name>
    (the real asset is not in the repository). Returns the REFERENCE_DIR
    that holds it."""
    from rendering_tpu_torch.flagship import procedural_mesh
    from rendering_tpu_torch.models.objloader import write_obj

    ref = os.path.join(WORKSPACE, "reference")
    objects = os.path.join(ref, "input", "objects")
    os.makedirs(objects, exist_ok=True)
    m = procedural_mesh(n_tris, pos=(0, 0, 0), size=(2, 2, 2))
    write_obj(os.path.join(objects, name), m.v, m.uv, m.n)
    return ref


def real_geometry_phase(ci, card_line) -> dict:
    """Phase 32: the flagship on real geometry from an OBJ, as bench.py's
    headline builds it: a stand-in shotgun.obj (the procedural mesh of
    SHOTGUN_TRIS triangles, the bundled asset's count) loaded by the C++
    runtime, `densify_mesh` to N_TRIS, the C++ BVH. K1 and K2 once per ray
    block, each held against its plain version on the middle block; the
    frame timed (CUDA events); the train step (repeat steps bit-equal);
    the frame bit-equal to that of the scene built through RTPU_NATIVE=0."""
    from rendering_tpu_torch import flagship
    from rendering_tpu_torch.render.pipeline import render_scene

    ref = write_stand_in("shotgun.obj", SHOTGUN_TRIS)
    densify: list = []
    build = functools.partial(flagship.build_flagship_scene, WIDTH, HEIGHT,
                              n_tris=N_TRIS, real_geometry=True)
    with reference_dir(ref), recorded(flagship, "densify_mesh", densify):
        with native_path("real-geometry flagship build") as nat:
            t0 = time.perf_counter()
            scene = build()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        with native_env("0"), native_path("real-geometry flagship build, "
                                          "RTPU_NATIVE=0", native_on=False):
            py_scene = build()
    ms0 = scene.static.meshes[0]
    print(f"real-geometry flagship (stand-in shotgun.obj, "
          f"{densify[0]['args'][0].n_tris} procedural triangles): densified "
          f"to {ms0.n_tris} triangles in {densify[0]['s']:.3f} s; OBJ load "
          f"{nat['obj_s'][0]:.3f} s, BVH {nat['bvh_s'][0]:.3f} s, scene build "
          f"{build_s:.3f} s; clipped {ms0.clipped_by_root}")
    if len(densify) != 2 or not N_TRIS * 0.9 < ms0.n_tris < N_TRIS * 1.1:
        raise AssertionError("real geometry: the mesh was not densified")
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    sfx = "_rootfilter" if ms0.clipped_by_root else ""
    names = (f"closest_hit{sfx}", f"any_hit{sfx}")
    kept: dict = {}
    counts: dict = {}
    with torch.no_grad(), keep_block(ci, n_blocks // 2, kept), \
            counted(ci, counts):
        frame3, _ = render_scene(scene)
    check_launches(counts, {n: n_blocks for n in names},
                   f"real-geometry render_scene ({n_blocks} ray blocks)")
    check_frame(scene, frame3, WIDTH, HEIGHT, "real-geometry flagship")
    bfc = scene.static.settings.use_backface_culling
    parity = {n: block_parity(ci, n, *kept[ci.KERNELS[n].anyhit], bfc,
                              "stand-in shotgun.obj, densified")
              for n in names}
    kept.clear()

    def forward():
        with torch.no_grad():
            render_scene(scene)

    frame_ms = mean_ms(forward, reps=3)
    with torch.no_grad():
        py_frame, _ = render_scene(py_scene)
    py_equal = torch.equal(frame3.view(torch.int32),
                           py_frame.view(torch.int32))
    print(f"real-geometry frame (stand-in shotgun.obj, densified) "
          f"{WIDTH}x{HEIGHT}, {ms0.n_tris} triangles: "
          f"{frame_ms:.3f} ms (CUDA events, mean of 3 after 1 warm-up); "
          f"bit-equal to the RTPU_NATIVE=0 scene's frame: {py_equal} on "
          f"{card_line}")
    if not py_equal:
        raise AssertionError("real geometry: the C++ and Python builds "
                             "render different frames")
    del py_scene, py_frame, frame3
    # As on the procedural flagship (phase 5), only the vertices get a
    # gradient.
    step = train(ci, scene, BENCH_PATHS, reps=2,
                 zero_ok=("lights/0/intensity", "obj_color"))
    check_launches(step["launches"], {n: n_blocks for n in names},
                   "real-geometry train step")
    print(f"real-geometry fwd+bwd step (stand-in shotgun.obj, densified) "
          f"{WIDTH}x{HEIGHT}: "
          f"{step['step_ms']:.3f} ms, {step['rays_per_s']:.4e} rays/s; peak "
          f"{step['peak_bytes'] / 2**30:.3f} GiB on {card_line}")
    del scene
    return {"stand_in_tris": densify[0]["args"][0].n_tris,
            "triangles": ms0.n_tris, "clipped": ms0.clipped_by_root,
            "densify_s": densify[0]["s"], "build_s": build_s,
            "native": nat, "frame_ms": frame_ms, "parity": parity,
            "launches": {k: n for k, n in counts.items() if n},
            "fwd_bwd": step}


def bunny_grid_phase(ci, card_line) -> dict:
    """Phase 33: the 16-mesh scene from OBJ files, `build_multimesh_scene(
    MM_WIDTH, MM_HEIGHT)` with tris_per_mesh=None over a stand-in
    bunny.obj (the procedural mesh of MM_TRIS_PER_MESH triangles): every
    cell's load and BVH through the C++ runtime; K5 closest and any hit
    once per ray block, each held against its plain version on the middle
    block; the frame and one train step timed."""
    from rendering_tpu_torch import flagship
    from rendering_tpu_torch.render.pipeline import render_scene

    ref = write_stand_in("bunny.obj", MM_TRIS_PER_MESH)
    with reference_dir(ref), native_path("16-mesh OBJ scene build") as nat:
        t0 = time.perf_counter()
        mm = flagship.build_multimesh_scene(MM_WIDTH, MM_HEIGHT,
                                            n_meshes=MM_MESHES)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    tris = [m.n_tris for m in mm.static.meshes]
    clipped = [m.clipped_by_root for m in mm.static.meshes]
    print(f"16-mesh scene from the stand-in bunny.obj: {tris} triangles, "
          f"clipped {clipped}; {nat['loads']} OBJ loads "
          f"{sum(nat['obj_s']):.3f} s, BVH {sum(nat['bvh_s']):.3f} s, scene "
          f"build {build_s:.3f} s")
    if tris != [MM_TRIS_PER_MESH] * MM_MESHES or nat["loads"] != MM_MESHES:
        raise AssertionError("the 16-mesh scene did not take the OBJ branch")
    sfx = "_rootfilter" if any(clipped) else ""
    names = (f"fused_closest_hit{sfx}", f"fused_any_hit{sfx}")
    mm_blocks = -(-MM_WIDTH * MM_HEIGHT // RAY_BLOCK)
    kept: dict = {}
    counts: dict = {}
    with torch.no_grad(), keep_block(ci, mm_blocks // 2, kept), \
            counted(ci, counts):
        frame3, _ = render_scene(mm)
    check_launches(counts, {n: mm_blocks for n in names},
                   f"16-mesh OBJ render_scene ({mm_blocks} ray blocks)")
    check_frame(mm, frame3, MM_WIDTH, MM_HEIGHT, "16-mesh OBJ scene")
    bfc = mm.static.settings.use_backface_culling
    parity = {n: block_parity(ci, n, *kept[ci.KERNELS[n].anyhit], bfc,
                              "16 stand-in bunny.obj")
              for n in names}
    kept.clear()
    del frame3

    def forward():
        with torch.no_grad():
            render_scene(mm)

    frame_ms = mean_ms(forward, reps=2)
    step = train(ci, mm, MM_PATHS, reps=1)
    check_launches(step["launches"], {n: mm_blocks for n in names},
                   "16-mesh OBJ train step")
    print(f"16-mesh scene (stand-in bunny.obj) {MM_WIDTH}x{MM_HEIGHT}: "
          f"frame {frame_ms:.3f} ms; fwd+bwd step {step['step_ms']:.3f} ms; "
          f"peak {step['peak_bytes'] / 2**30:.3f} GiB on {card_line}")
    del mm
    return {"triangles": tris, "clipped": clipped, "native": nat,
            "build_s": build_s, "frame_ms": frame_ms, "parity": parity,
            "launches": {k: n for k, n in counts.items() if n},
            "fwd_bwd": step}


# ---- 34-37: several ranks ---------------------------------------------------


def md_file(name: str) -> str:
    return os.path.join(MD_DIR, name)


def param_digest(params: dict) -> str:
    """SHA-1 of every parameter's bytes in key order: equal digests on
    two ranks mean the same bits."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(params):
        h.update(params[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def grads_close(got: dict, want: dict, rtol: float, scale: float = 1.0):
    """(ok, the largest |got - want| / (rtol * (|want| + max|want|)) over
    the parameters): each gradient within rtol of want * scale, atol
    rtol * max|want * scale| (0 where want is 0)."""
    import numpy as np

    worst = 0.0
    for k, w in want.items():
        w = w * scale
        g = got[k]
        tol = rtol * (np.abs(w) + np.abs(w).max())
        excess = np.abs(g - w) - tol
        if w.any():
            worst = max(worst, float((np.abs(g - w) / np.maximum(
                tol, 1e-30)).max()))
        elif g.any():
            return False, float("inf")
        if (excess > 0).any():
            return False, worst
    return True, worst


def blocks_of(n_rays: int) -> int:
    return math.ceil(n_rays / RAY_BLOCK)


def sharded_blocks(r: int, world: int, wh=None) -> int:
    """Ray blocks of one rank's share of r rays over `world` ranks."""
    from rendering_tpu_torch.parallel.shard import _round_robin_layout

    rp, _ = _round_robin_layout(r, world, wh)
    return blocks_of(rp // world)


def rank_phases(ci, rank: int, world: int, dev, say) -> dict:
    """Phases 35-37 on one rank: the ray-sharded flagship (frame and
    train step under both schedules), the geometry-sharded 16-mesh scene,
    and t10's workload through cli.main (ray-sharded strips, then
    --geo-shard 2). Every check raises; the numbers are returned."""
    import numpy as np
    import torch.distributed as dist

    from rendering_tpu_torch import cli
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.flagship import (
        build_flagship_scene,
        build_multimesh_scene,
    )
    from rendering_tpu_torch.parallel import geoshard, shard
    from rendering_tpu_torch.parallel.overlap import make_sharded_grad_fn
    from rendering_tpu_torch.render.pipeline import quantize_u8

    out: dict = {}
    lap = Laps(prefix=f"rank {rank} ")
    mesh = shard.make_ray_mesh(device=dev)

    def timed(fn, reps=2):
        """Host seconds of each of `reps` calls, the ranks lined up by a
        barrier before each."""
        times = []
        for _ in range(reps):
            dist.barrier()
            t, _ = host_s(fn)
            times.append(t)
        return times

    # ---- 35. the ray-sharded flagship: frame ---------------------------
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS, device=dev)
    blocks = sharded_blocks(WIDTH * HEIGHT, world, (WIDTH, HEIGHT))
    counts: dict = {}
    with torch.no_grad(), counted(ci, counts):
        frame3, _ = shard.render_scene_sharded(scene, mesh)
    check_launches(counts, {"closest_hit": blocks, "any_hit": blocks},
                   f"rank {rank}: sharded flagship frame ({blocks} ray "
                   f"blocks)")
    u8 = quantize_u8(frame3).cpu().numpy()
    n_u8 = int((u8 != np.load(md_file("flag_u8.npy"))).sum())
    f32_diff = float(np.abs(frame3.cpu().numpy()
                            - np.load(md_file("flag_f32.npy"))).max())
    with torch.no_grad():
        frame_s = timed(lambda: shard.render_scene_sharded(scene, mesh))
    say(f"sharded flagship {WIDTH}x{HEIGHT}: {n_u8} u8 values differ from "
        f"phase 1's frame, max |f32 diff| {f32_diff:.3e}; frame "
        f"{[round(t, 4) for t in frame_s]} s")
    if n_u8:
        raise AssertionError("the sharded flagship frame differs from "
                             "phase 1's")
    out["flagship"] = {"frame_launches": {k: n for k, n in counts.items()
                                          if n},
                       "u8_differing": n_u8, "max_abs_f32_diff": f32_diff,
                       "frame_s": frame_s}
    del frame3
    lap("35 sharded flagship frame")

    # ---- 35. the ray-sharded flagship: train step, both schedules -------
    ref = dict(np.load(md_file("flag_grads.npz")))
    ref = {k.replace("|", "/"): v for k, v in ref.items()}
    target = train_target(scene)
    init, step = make_train_step(BENCH_PATHS, mesh=mesh)

    def first_step():
        params = extract_params(scene, BENCH_PATHS)
        state = init(params)
        params, state, loss = step(params, state, scene, target)
        torch.cuda.synchronize()
        return params, state, loss, {k: v.grad.cpu().numpy().copy()
                                     for k, v in params.items()}

    step_counts: dict = {}
    with counted(ci, step_counts):
        params, state, loss, grads = first_step()
    check_launches(step_counts, {"closest_hit": blocks, "any_hit": blocks},
                   f"rank {rank}: sharded flagship train step")
    ok, worst = grads_close(grads, ref, GRAD_RTOL)
    params2, _, loss2, grads2 = first_step()
    repeat = (float(loss) == float(loss2) and all(
        np.array_equal(grads[k], grads2[k]) for k in grads)
        and param_digest(params) == param_digest(params2))
    params, state, _ = step(params, state, scene, target)
    digest = param_digest(params)
    step_s = timed(lambda: step(params, state, scene, target))
    say(f"sharded train step: gradients vs phase 5's within rtol "
        f"{GRAD_RTOL}: {ok} (worst {worst:.3e} of the tolerance); repeat "
        f"step bit-equal: {repeat}; parameters after two steps {digest}; "
        f"step {[round(t, 4) for t in step_s]} s")
    if not ok or not repeat:
        raise AssertionError("the sharded train step disagrees with phase "
                             "5 or with itself")
    # make_sharded_grad_fn's loss leaves the dead row and column out and
    # averages over (W - 1)(H - 1) pixels: the same gradient scaled.
    scale = WIDTH * HEIGHT / ((WIDTH - 1) * (HEIGHT - 1))
    sched = {}
    for overlap in (True, False):
        fn = make_sharded_grad_fn(BENCH_PATHS, mesh, overlap=overlap)
        p = extract_params(scene, BENCH_PATHS)
        counts = {}
        with counted(ci, counts):
            _, g = fn(p, scene, target)
        check_launches(counts, {"closest_hit": blocks, "any_hit": blocks},
                       f"rank {rank}: make_sharded_grad_fn overlap={overlap}")
        g = {k: v.cpu().numpy().copy() for k, v in g.items()}
        ok, worst = grads_close(g, ref, GRAD_RTOL, scale)
        times = timed(lambda fn=fn, p=p: fn(p, scene, target))
        sched[overlap] = {"grads": g, "ok": ok, "worst": worst,
                          "s": times}
        say(f"make_sharded_grad_fn overlap={overlap}: gradients vs phase "
            f"5's (x {scale:.6f}) within rtol {GRAD_RTOL}: {ok} (worst "
            f"{worst:.3e}); {[round(t, 4) for t in times]} s")
        if not ok:
            raise AssertionError(f"make_sharded_grad_fn overlap={overlap} "
                                 f"disagrees with phase 5")
    agree, worst = grads_close(sched[True]["grads"], sched[False]["grads"],
                               1e-6)
    say(f"the two schedules' gradients within rtol 1e-6: {agree} (worst "
        f"{worst:.3e})")
    if not agree:
        raise AssertionError("the two all-reduce schedules disagree")
    out["flagship"].update(
        step_launches={k: n for k, n in step_counts.items() if n},
        step_repeat_bit_equal=repeat, params_digest=digest, step_s=step_s,
        grad_fn_s={str(k): v["s"] for k, v in sched.items()},
        grad_fn_worst={str(k): v["worst"] for k, v in sched.items()})
    del scene, params, params2, state, target
    torch.cuda.empty_cache()
    lap("35 sharded flagship train step")

    # ---- 36. the geometry-sharded 16-mesh scene, layout (1, world) -------
    gmesh = geoshard.make_geo_mesh(world, device=dev)
    gscene = build_multimesh_scene(
        MM_WIDTH, MM_HEIGHT, n_meshes=MM_MESHES,
        tris_per_mesh=MM_TRIS_PER_MESH,
        settings_overrides=dict(geo_shard_axis="geo"), device=dev)
    mm_blocks = blocks_of(MM_WIDTH * MM_HEIGHT)
    counts = {}
    with torch.no_grad(), counted(ci, counts):
        gu8, _ = geoshard.render_geo_sharded(gscene, gmesh, out_u8=True)
    check_launches(counts, {"fused_closest_hit": mm_blocks,
                            "fused_any_hit": mm_blocks},
                   f"rank {rank}: geometry-sharded 16-mesh frame (its shard "
                   f"of the tables, {mm_blocks} ray blocks)")
    n_u8 = int((gu8 != np.load(md_file("mm_u8.npy"))).sum())
    acct = geoshard.geo_shard_memory_accounting(gscene, gmesh)
    geo_s = timed(lambda: geoshard.render_geo_sharded(gscene, gmesh))
    say(f"geometry-sharded 16-mesh {MM_WIDTH}x{MM_HEIGHT} (1, {world}): "
        f"{n_u8} u8 values differ from phase 6's frame; bytes {acct}; "
        f"frame {[round(t, 4) for t in geo_s]} s")
    if n_u8:
        raise AssertionError("the geometry-sharded frame differs from "
                             "phase 6's")
    if acct["per_triangle_bytes_rank"] * world != acct["sharded_bytes_total"]:
        raise AssertionError("a rank holds more than its share of the "
                             "per-triangle tables")
    out["geo"] = {"launches": {k: n for k, n in counts.items() if n},
                  "u8_differing": n_u8, "bytes": acct, "frame_s": geo_s}
    del gscene
    torch.cuda.empty_cache()
    lap("36 geometry-sharded 16-mesh")

    # ---- 37. t10's workload through cli.main: sharded strips, geo ----------
    scene_path = os.path.join(WORKSPACE, "shotgun_progress.scene")
    for key, extra, mod in (("cli", (), shard),
                            ("cli_geo", ("--geo-shard", str(world)),
                             geoshard)):
        strips: list = []
        ssaa: list = []
        counts = {}
        bmp = md_file(f"{key}.bmp")
        buf = io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(logged(mod, "render_strip_sharded", strips))
            stack.enter_context(logged(mod, "ssaa_pass_sharded", ssaa))
            stack.enter_context(native_path(f"rank {rank} {key}"))
            stack.enter_context(counted(ci, counts))
            stack.enter_context(contextlib.redirect_stdout(buf))
            t0 = time.perf_counter()
            rc = cli.main([scene_path, "--output", bmp, *extra])
            cli_s = time.perf_counter() - t0
        ray_world = 1 if extra else world
        n = sum(sharded_blocks(kw["rows"] * SCENE_W, ray_world,
                               (SCENE_W, kw["rows"])) for kw in strips)
        n += sum(blocks_of(4 * -(-kw["capacity"] // ray_world)) for kw in ssaa)
        names = (("fused_closest_hit_rootfilter", "fused_any_hit_rootfilter")
                 if extra else ("closest_hit_rootfilter",
                                "any_hit_rootfilter"))
        check_launches(counts, {names[0]: n, names[1]: n},
                       f"rank {rank}: cli.main {' '.join(extra)} "
                       f"outputProgress=1 ({len(strips)} strips)")
        say(f"cli.main {' '.join(extra) or '(rays sharded)'}: rc {rc}, "
            f"{len(strips)} strips, {n} ray blocks a kernel, {cli_s:.3f} s; "
            f"printed {len(buf.getvalue())} characters")
        if rc or (rank and buf.getvalue()):
            raise AssertionError("cli.main failed, or a rank other than 0 "
                                 "printed")
        out[key] = {"launches": {k: v for k, v in counts.items() if v},
                    "strips": len(strips), "cli_s": cli_s,
                    "printed": buf.getvalue() if rank == 0 else ""}
    lap("37 cli.main on two ranks")
    return out


def rank_main(rank: int, world: int, port: int) -> None:
    """One rank of phases 35-37, a process of its own (spawned by
    `multidevice_phase`; the kernels are built already): joins the group
    (`multihost.initialize_distributed`, which picks and prints the
    backend), checks the port's collectives on its device, runs
    `rank_phases`, and writes its numbers, or its traceback, to
    build/chip_smoke/multidevice/rank<r>.json."""
    import traceback

    import torch.distributed as dist

    from rendering_tpu_torch.ops import cuda_intersect as ci
    from rendering_tpu_torch.parallel import collectives, multihost, shard

    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))

    def say(msg):
        print(f"rank {rank}: {msg}", flush=True)

    out = {"rank": rank}
    try:
        multihost.initialize_distributed(f"localhost:{port}", world, rank)
        dev = multihost.rank_device()
        mesh = shard.make_ray_mesh(device=dev)
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        base = torch.arange(4, dtype=torch.float32)
        got = [collectives.all_reduce(mesh.rays, x).cpu(),
               collectives.all_gather(mesh.rays, x).cpu()]
        want = [base * world + 10 * sum(range(world)),
                torch.cat([base + 10 * r for r in range(world)])]
        coll_ok = all(torch.equal(a, b) for a, b in zip(got, want))
        out.update(device=str(dev), backend=dist.get_backend(),
                   cards=torch.cuda.device_count(), collectives_ok=coll_ok,
                   topology=multihost.process_topology())
        say(f"{out['backend']} on {dev}, {world} ranks, "
            f"{out['cards']} card(s); all_reduce, all_gather: {coll_ok}")
        if not coll_ok:
            raise AssertionError(f"collectives: {got} != {want}")
        out.update(rank_phases(ci, rank, world, dev, say))
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(md_file(f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh, default=str)
        if dist.is_initialized():
            dist.destroy_process_group()


def nccl_one_rank(card_line) -> dict:
    """One rank on NCCL in this process, whatever the card count: the
    port's init picks NCCL for a rank with a card of its own, and the
    three collectives run on it."""
    import socket

    import torch.distributed as dist

    from rendering_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    saved = {k: os.environ.pop(k, None) for k in ("LOCAL_RANK",
                                                  "LOCAL_WORLD_SIZE")}
    try:
        multihost.initialize_distributed(f"localhost:{port}", 1, 0,
                                         device="cuda")
        backend = dist.get_backend()
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        z = x.clone()
        dist.broadcast(z, src=0)
        torch.cuda.synchronize()
        ok = (backend == "nccl" and torch.equal(y, x)
              and torch.equal(parts[0], x) and torch.equal(z, x))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    print(f"one rank on {backend}: all_reduce, all_gather, broadcast on the "
          f"card: {ok} on {card_line}")
    if not ok:
        raise AssertionError("NCCL with one rank failed")
    return {"backend": backend, "ok": ok}


def multidevice_phase(ci, card_line) -> dict:
    """Phases 34-37: one rank on NCCL here, then MD_RANKS ranks, each a
    spawned process running `rank_main` (NCCL with a card each when there
    are as many cards, else gloo on cuda:0, ranks sharing the card),
    within MD_TIMEOUT_S; the ranks' checks, then across them: the same
    parameter digest after two sharded steps, and each cli.main BMP within
    test_golden.py's default limits of phase 24's."""
    import socket

    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    nccl = nccl_one_rank(card_line)
    world = MD_RANKS
    cards = torch.cuda.device_count()
    label = (f"{world} ranks on {cards} cards" if cards >= world
             else f"{world} ranks on one card")
    for r in range(world):
        with contextlib.suppress(FileNotFoundError):
            os.remove(md_file(f"rank{r}.json"))
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, port))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + MD_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks_s = time.perf_counter() - t0
    res = []
    for r, p in enumerate(procs):
        try:
            with open(md_file(f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        except FileNotFoundError:
            res.append({"rank": r})
        if p.exitcode != 0 or not res[-1].get("ok"):
            raise AssertionError(f"rank {r} exited {p.exitcode}: "
                                 f"{res[-1].get('error', 'no result')}")
    digests = {r["flagship"]["params_digest"] for r in res}
    if len(digests) != 1:
        raise AssertionError(f"the ranks' parameters differ: {digests}")
    gold = bmp_to_image(load_bmp(os.path.join(
        WORKSPACE, "shotgun_progress.bmp")))
    measures = {}
    for key in ("cli", "cli_geo"):
        measures[key] = golden_measures(
            bmp_to_image(load_bmp(md_file(f"{key}.bmp"))), gold)
        if any(m > t for m, t in zip(measures[key], DEFAULT_GOLDEN_TOL)):
            raise AssertionError(f"{key} BMP outside phase 24's limits: "
                                 f"{measures[key]}")
    print(f"multi-device ({label}, backend {res[0]['backend']}): the ranks' "
          f"parameters after two steps equal ({digests.pop()}); cli.main "
          f"BMPs vs phase 24's: {measures} (limits {DEFAULT_GOLDEN_TOL}); "
          f"the ranks ran {ranks_s:.1f} s on {card_line}")
    return {"label": label, "backend": res[0]["backend"],
            "cards": cards, "ranks": world,
            "nccl_one_rank": nccl, "ranks_s": ranks_s,
            "bmp_measures": measures,
            "per_rank": [{k: r[k] for k in ("flagship", "geo", "cli",
                                             "cli_geo")} for r in res]}


def hit_differences(scene_a, scene_b, ro, rd) -> dict:
    """`integrator.trace_closest` of rays ro/rd (R, 3) on two settings of
    one scene (its gather tables derived), a ray block at a time: the rays
    whose hit (object, triangle) differs between the two, and how many of
    those are ties, where both hits' t, re-evaluated through
    ray_triangle_r, are bit-equal."""
    from rendering_tpu_torch.render.integrator import trace_closest

    differ = ties = 0
    for b in range(0, ro.shape[0], RAY_BLOCK):
        ro3 = ro[b:b + RAY_BLOCK].T.contiguous()
        rd3 = rd[b:b + RAY_BLOCK].T.contiguous()
        with torch.no_grad():
            ha, _ = trace_closest(scene_a, ro3, rd3)
            hb, _ = trace_closest(scene_b, ro3, rd3)
        d = (ha.obj != hb.obj) | (ha.tri != hb.tri)
        differ += int(d.sum())
        ties += int((d & (ha.t.view(torch.int32)
                          == hb.t.view(torch.int32))).sum())
    return {"rays": int(ro.shape[0]), "differ": differ, "ties": ties}


def walk_numbers(traversal, query, n_plain: int) -> dict:
    """The walk's kernel against its plain version on a query that
    `kept_call` kept from `integrator.traverse_bvh` (its first n_plain
    rays): ids equal, t, u, v bit-equal, both counters
    equal; the plain walk's host seconds there, the kernel's ms on the
    whole query (CUDA events, mean of 5) and its counters."""
    mesh, ro, rd, tl = query["args"]
    kw = query["kwargs"]
    sl = slice(0, n_plain)
    part = (ro[sl].contiguous(), rd[sl].contiguous(),
            tl[sl].contiguous() if tl is not None else None)
    plain_s, want = host_s(lambda: traversal.traverse_bvh_plain(
        mesh, *part, **kw))
    got = traversal.traverse_bvh(mesh, *part, **kw)
    mism = {"ids": int((got.tri != want.tri).sum())}
    for name in ("t", "u", "v"):
        mism[name] = int((getattr(got, name).view(torch.int32)
                          != getattr(want, name).view(torch.int32)).sum())
    mism["counters"] = [int(got.box_tests) - int(want.box_tests),
                        int(got.tri_tests) - int(want.tri_tests)]
    whole = traversal.traverse_bvh(mesh, ro, rd, tl, **kw)
    ms = mean_ms(lambda: traversal.traverse_bvh(mesh, ro, rd, tl, **kw),
                 reps=5)
    return {"rays": int(ro.shape[0]), "plain_rays": int(part[0].shape[0]),
            "hits": int((whole.tri >= 0).sum()),
            "box_tests": int(whole.box_tests),
            "tri_tests": int(whole.tri_tests), "ms": ms,
            "plain_s": plain_s, "mismatches": mism,
            "max_abs_err": float((got.t - want.t).abs().max())}


def walk_bound(mesh, q: dict, limited: bool) -> dict:
    """The least time of a walk query: its f32 operations (the slab tests
    and pair tests its counters count, AC_SLAB_OPS and OPS_PER_PAIR each)
    at F32_OPS_RATE, or its bytes (the rays and limits read once, the
    nodes, leaf ids and vertices once, t, id, u, v written once) at
    HBM_RATE, the larger."""
    ops = q["box_tests"] * AC_SLAB_OPS + q["tri_tests"] * OPS_PER_PAIR
    nbytes = (q["rays"] * (24 + 4 * limited + 16)
              + sum(getattr(mesh, k).numel() * 4
                    for k in ("node_min", "node_max", "skip", "leaf_start",
                              "leaf_count", "real_flag", "leaf_tris", "v")))
    ops_ms = ops / F32_OPS_RATE * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def bvh_flagship_phase(ci, card_line, flag_loss: float) -> tuple[dict, dict]:
    """Phase 38: the flagship built with use_pallas_intersect=False (the
    250k mesh is above bruteforce_threshold, so every query walks the BVH
    through `bvh_closest`): the frame (each ray block's closest hits and
    shadow rays, one launch each, no mesh kernel), timed; the middle
    block's two queries through the kernel against the plain walk (the
    first BVH_PLAIN_RAYS rays) and timed; the primary hits against the
    mesh kernels' (phase 1's path) on every ray, differing ones ties; the
    u8 frame against phase 1's; a train step, its repeat bit-equal, its
    loss and gradients against phase 5's. Returns (numbers, the kernel
    row's numbers)."""
    import numpy as np

    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.ops import traversal
    from rendering_tpu_torch.render import integrator, pipeline
    from rendering_tpu_torch.render.raygen import primary_rays

    t0 = time.perf_counter()
    scene = build_flagship_scene(
        WIDTH, HEIGHT, n_tris=N_TRIS,
        settings_overrides=dict(use_pallas_intersect=False))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = scene.meshes[0]
    if scene.static.meshes[0].n_tris <= scene.static.settings.bruteforce_threshold:
        raise AssertionError("the flagship mesh must take the BVH walk")
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    # The middle block's two walks: its closest hits, then its shadow rays.
    kept = {"closest": {}, "shadow": {}}
    mid = n_blocks // 2
    counts: dict = {}
    with torch.no_grad(), \
            kept_call(integrator, "traverse_bvh", 2 * mid, kept["closest"]), \
            kept_call(integrator, "traverse_bvh", 2 * mid + 1, kept["shadow"]), \
            counted(ci, counts):
        frame3, aux = pipeline.render_scene(scene)
    check_launches(counts, {"bvh_closest": 2 * n_blocks},
                   f"BVH-walk flagship render_scene ({n_blocks} ray blocks)")
    check_frame(scene, frame3, WIDTH, HEIGHT, "BVH-walk flagship")
    u8 = pipeline.quantize_u8(frame3).cpu().numpy()
    u8_diff = int((u8 != np.load(md_file("flag_u8.npy"))).sum())
    stats = {k: float(v) for k, v in aux["stats"].items()}

    def forward(s):
        def run():
            with torch.no_grad():
                pipeline.render_scene(s)
        return run

    # In turns with the mesh kernels' frame (phase 1's path) on the same
    # tensors: kernels, walk, walk, kernels.
    kernels = with_settings(scene, use_pallas_intersect=True)
    turns = [mean_ms(forward(x), reps=2)
             for x in (kernels, scene, scene, kernels)]
    frame_ms = (turns[1] + turns[2]) / 2
    print(f"BVH-walk flagship frame {WIDTH}x{HEIGHT}: {frame_ms:.3f} ms "
          f"(built in {build_s:.1f} s); A/B frame ms, mesh kernels, BVH "
          f"walk, BVH walk, mesh kernels: {turns}; {u8_diff} u8 values differ from "
          f"phase 1's frame; stats {stats} on {card_line}")

    queries = {}
    for key in ("closest", "shadow"):
        q = walk_numbers(traversal, kept[key], BVH_PLAIN_RAYS)
        q.update(walk_bound(m, q, key == "shadow"))
        queries[key] = q
        print(f"bvh_closest {key} query, middle block: {json.dumps(q)}")
        mism = q["mismatches"]
        if any(mism[k] for k in ("ids", "t", "u", "v")) or any(
                mism["counters"]) or q["hits"] == 0:
            raise AssertionError(f"bvh_closest disagrees with the plain "
                                 f"walk on the {key} query: {mism}")
    del kept

    derived = pipeline.derive_mesh_tables(scene)
    ro, rd, _ = primary_rays(scene)
    ties = hit_differences(derived, with_settings(
        derived, use_pallas_intersect=True), ro, rd)
    print(f"primary hits, BVH walk vs mesh kernels: {json.dumps(ties)}")
    if ties["differ"] != ties["ties"]:
        raise AssertionError("a primary hit of the BVH walk differs from "
                             "the mesh kernels' other than by a tie")
    del derived, ro, rd, frame3, kernels

    grads: dict = {}
    step = train(ci, scene, BENCH_PATHS, reps=1,
                 zero_ok=("lights/0/intensity", "obj_color"), kept=grads)
    check_launches(step["launches"], {"bvh_closest": 2 * n_blocks},
                   "BVH-walk flagship train step")
    ref = {k.replace("|", "/"): v
           for k, v in np.load(md_file("flag_grads.npz")).items()}
    ok, worst = grads_close(grads, ref, GRAD_RTOL)
    loss_err = abs(step["loss"] - flag_loss) / abs(flag_loss)
    print(f"BVH-walk flagship fwd+bwd step: {step['step_ms']:.3f} ms, peak "
          f"{step['peak_bytes'] / 2**30:.3f} GiB; loss {step['loss']:.8f} "
          f"(phase 5 {flag_loss:.8f}, rel {loss_err:.3e}); gradients vs "
          f"phase 5's: worst {worst:.3e} of the tolerance on {card_line}")
    if not ok or loss_err > GRAD_RTOL:
        raise AssertionError("the BVH walk's train step is outside phase "
                             "5's tolerance")
    del scene
    torch.cuda.empty_cache()
    out = {"build_s": build_s, "frame_ms": frame_ms, "ab_frame_ms": turns,
           "stats": stats,
           "u8_diff_phase1": u8_diff, "primary_vs_mesh_kernels": ties,
           "queries": queries, "fwd_bwd": step, "grad_worst": worst,
           "loss_rel_err": loss_err}
    c = queries["closest"]
    row = {"launches": counts["bvh_closest"],
           "launches_by_path": {"bvh_flagship_frame": counts["bvh_closest"],
                                "bvh_flagship_step":
                                    step["launches"]["bvh_closest"]},
           "max_abs_err": max(q["max_abs_err"] for q in queries.values()),
           "ms": c["ms"], "plain_ms": c["plain_s"] * 1e3,
           "plain_rays": c["plain_rays"], "bound_ms": c["bound_ms"],
           "bound_by": c["bound_by"], "shadow_ms": queries["shadow"]["ms"]}
    return out, row


def dense_multimesh_phase(ci, card_line) -> dict:
    """Phase 39: the 16-mesh scene built with use_pallas_intersect=False
    (every mesh at or below bruteforce_threshold: the dense scans) at
    DENSE_WH (at 1920x1080 the direct frame alone takes ~110 s): the
    frame with use_mxu_intersect on and off, timed once each, no kernel
    launched; against phase 6's path (K5) at the same size: the direct
    frame u8-equal but at tie rays (each differing pixel's primary ray
    checked), the bilinear frame within test_golden.py's default limits;
    the middle block's primary hits through the bilinear form twice under
    deterministic algorithms, bit-equal (its cuBLAS product lifts the
    mode's alert, `ops.bruteforce_mxu.matmul_f32`)."""
    import numpy as np

    from rendering_tpu_torch.device import deterministic_algorithms
    from rendering_tpu_torch.flagship import build_multimesh_scene
    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.render.integrator import trace_closest
    from rendering_tpu_torch.render.raygen import primary_rays

    w, h = DENSE_WH
    dense = build_multimesh_scene(
        w, h, n_meshes=MM_MESHES, tris_per_mesh=MM_TRIS_PER_MESH,
        settings_overrides=dict(use_pallas_intersect=False))
    if max(ms.n_tris for ms in dense.static.meshes) > \
            dense.static.settings.bruteforce_threshold:
        raise AssertionError("every mesh must take the dense scan")
    kernels = with_settings(dense, use_pallas_intersect=True)
    with torch.no_grad():
        ref = pipeline.quantize_u8(pipeline.render_scene(kernels)[0])
    out = {"wh": [w, h]}
    frames = {}
    for mxu in (True, False):
        scene = with_settings(dense, use_mxu_intersect=mxu)
        counts: dict = {}
        with torch.no_grad(), counted(ci, counts):
            s, (frame3, aux) = host_s(lambda: pipeline.render_scene(scene))
        print(f"dense multimesh (mxu={mxu}) launches: "
              f"{ {k: n for k, n in counts.items() if n} }")
        if any(counts.values()):
            raise AssertionError("the dense path launched a kernel")
        check_frame(scene, frame3, w, h, f"dense multimesh mxu={mxu}")
        frames[mxu] = pipeline.quantize_u8(frame3)
        out["mxu" if mxu else "direct"] = {
            "frame_s": s,
            "stats": {k: float(v) for k, v in aux["stats"].items()},
            "u8_diff_k5": int((frames[mxu] != ref).sum())}
    out["mxu"]["golden_measures"] = golden_measures(
        frames[True].cpu().numpy(), ref.cpu().numpy())
    derived = pipeline.derive_mesh_tables(dense)
    ro, rd, pix = primary_rays(dense)
    mid = (-(-ro.shape[0] // RAY_BLOCK) // 2) * RAY_BLOCK
    ro3 = ro[mid:mid + RAY_BLOCK].T.contiguous()
    rd3 = rd[mid:mid + RAY_BLOCK].T.contiguous()
    with torch.no_grad(), deterministic_algorithms():
        a, _ = trace_closest(derived, ro3, rd3)
        b, _ = trace_closest(derived, ro3, rd3)
    out["mxu"]["repeat_bit_equal"] = bool(
        torch.equal(a.tri, b.tri) and torch.equal(a.obj, b.obj)
        and torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)))
    # Each pixel where the direct frame differs: its primary ray on both
    # paths.
    sel = (frames[False] != ref).any(dim=-1).reshape(-1)[pix.long()]
    ties = hit_differences(with_settings(derived, use_mxu_intersect=False),
                           with_settings(derived, use_pallas_intersect=True),
                           ro[sel], rd[sel])
    out["direct"]["differing_pixels"] = ties
    print(f"dense multimesh {w}x{h}: {json.dumps(out)} on {card_line}")
    if ties["ties"] != ties["rays"]:
        raise AssertionError("the direct dense frame differs from the "
                             "kernels' other than at tie rays")
    if any(m > t for m, t in zip(out["mxu"]["golden_measures"],
                                 DEFAULT_GOLDEN_TOL)):
        raise AssertionError("the bilinear frame is outside test_golden.py's"
                             " default limits of the kernels' frame")
    if not out["mxu"]["repeat_bit_equal"]:
        raise AssertionError("repeat bilinear hits differ under "
                             "deterministic algorithms")
    return out


def accumulate_bound_ms(call) -> float:
    """The index accumulation's least time at MEASURED_HBM_RATE: the ids
    read, the sorted keys (int32) and permutation (int64) written and
    read once, the values read, the accumulator read and written."""
    accum, idx, values = call
    n_ch, n = accum.shape
    q = idx.shape[0]
    moved = (q * idx.element_size() + 2 * q * (4 + 8) + n_ch * q * 4
             + 2 * n_ch * n * 4)
    return moved / MEASURED_HBM_RATE * 1e3


def index_accumulate_phase(card_line) -> dict:
    """Phase 40: the integrator's index accumulation
    (csrc/index_accumulate.cu, `ops.accumulate`) on
    tests/scenes/t01_simple_shapes.scene at 800x600 (the benchmark's
    simpleshapes cells): one frame with SSAA (11 bounces) and one train
    step of light 0's intensity and obj_color (SSAA off), each run twice
    and bit-equal, recording every call: the calls a frame and a step.
    On the frame's largest scatter (524,288 lanes x 3 into the pixels)
    and the step's per-object gather backward (131,072 lanes into 5
    rows): the kernel bit-equal to its plain version, ms a launch, the
    plain version's ms and the library's deterministic `index_add`
    (PyTorch's sort-based indexing_backward kernel, a yardstick only),
    and the bound in bytes."""
    from rendering_tpu_torch.device import deterministic_algorithms
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.models.scene import load_scene
    from rendering_tpu_torch.models.settings import RenderSettings
    from rendering_tpu_torch.ops import accumulate
    from rendering_tpu_torch.render import integrator, pipeline

    base = load_scene(os.path.join(TESTS, "scenes", "t01_simple_shapes.scene"),
                      RenderSettings(), device="cuda")
    w, h = ACCUM_WH

    def sized(**kw):
        st = base.static
        return dataclasses.replace(base, static=dataclasses.replace(
            st, settings=st.settings.replace(width=w, height=h, **kw)))

    frame_scene = sized(enable_ssaa=True)
    calls: list = []
    frames = []
    for _ in range(2):
        calls.clear()
        with torch.no_grad(), recorded(integrator, "index_accumulate", calls), \
                recorded(pipeline, "index_accumulate", calls):
            frames.append(pipeline.render_scene(frame_scene)[0])
    frame_calls = [c["args"] for c in calls]
    if not torch.equal(frames[0].view(torch.int32),
                       frames[1].view(torch.int32)):
        raise AssertionError("repeat simple_shapes frames differ")

    scene = sized(enable_ssaa=False)
    paths = (("lights", 0, "intensity"), ("obj_color",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    target = torch.rand((3, h, w), generator=gen, device="cuda")
    init, step_fn = make_train_step(paths)
    steps = []
    for _ in range(2):
        calls.clear()
        params = extract_params(scene, paths)
        with recorded(integrator, "index_accumulate", calls), \
                recorded(accumulate, "index_accumulate", calls):
            params, _, loss = step_fn(params, init(params), scene, target)
        torch.cuda.synchronize()
        steps.append([loss] + [t for v in params.values()
                               for t in (v.detach().clone(), v.grad.clone())])
    step_calls = [c["args"] for c in calls]
    if not all(torch.equal(a, b) for a, b in zip(*steps)):
        raise AssertionError("repeat simple_shapes train steps differ")

    # The per-object gathers' backward: the calls into a few object rows.
    backward = [c for c in step_calls if c[0].shape[1] == len(
        base.static.obj_kinds)]
    kept = {"frame_scatter": max(frame_calls, key=lambda c: c[1].shape[0]),
            "step_gather_backward": backward[0]}
    rows = {}
    for name, (accum, idx, values) in kept.items():
        idx, values = idx.contiguous(), values.contiguous()
        k = accumulate.index_accumulate(accum, idx, values)
        p = accumulate.index_accumulate_plain(accum, idx, values)
        if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
            raise AssertionError(f"{name}: the kernel differs from its plain "
                                 f"version")
        with torch.no_grad():
            ms = mean_ms(lambda: accumulate.index_accumulate(
                accum, idx, values), reps=20)
            plain_ms = mean_ms(lambda: accumulate.index_accumulate_plain(
                accum, idx, values), reps=3)
            with deterministic_algorithms():
                library_ms = mean_ms(lambda: accum.index_add(1, idx, values),
                                     reps=3)
        rows[name] = {
            "lanes": idx.shape[0], "channels": accum.shape[0],
            "columns": accum.shape[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": accumulate_bound_ms((accum, idx, values))}
    out = {"wh": [w, h], "frame_launches": len(frame_calls),
           "step_launches": len(step_calls),
           "step_gather_backward_launches": len(backward),
           "repeat_bit_equal": True, "calls": rows}
    print(f"index accumulation on simple_shapes {w}x{h}: {json.dumps(out)} "
          f"on {card_line}")
    return out


def glass_train_phase(ci, card_line) -> dict:
    """Phase 41: the benchmark's glass250k cell at its full size through
    `make_train_step` (module docstring)."""
    import copy

    sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "benchmark"))
    from harness import registry, scenes

    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.ops import accumulate
    from rendering_tpu_torch.render.integrator import (
        QueueGrowth,
        growing_queue,
        trace_closest,
    )
    from rendering_tpu_torch.render.pipeline import (
        derive_mesh_tables,
        render_scene,
    )
    from rendering_tpu_torch.render.raygen import primary_rays

    t0 = time.perf_counter()
    cell = registry.workload("glass250k.train")
    cfg = registry.config("glass250k")
    desc = scenes.describe(cfg, GLASS_SEED, cell["params"]["settings"])
    scene = scenes.program_scene(desc, "cuda")
    st = scene.static.settings
    w, h = st.width, st.height
    glass = next(i for i, o in enumerate(desc["objects"])
                 if o.get("material") == "transparent")
    with torch.no_grad():
        derived = derive_mesh_tables(scene)
        ro, rd, _ = primary_rays(derived, offset=1.0)
        share = 0.0
        for b in range(0, ro.shape[0], 1 << 17):
            hit, _ = trace_closest(derived, ro[b:b + (1 << 17)].T.contiguous(),
                                   rd[b:b + (1 << 17)].T.contiguous())
            share += float(((hit.obj == glass) & hit.hit).sum())
        share /= w * h
        _, aux1 = render_scene(scene)
        growth = QueueGrowth()
        with growing_queue(growth):
            render_scene(scene)
    dropped_h1 = int(aux1["stats"]["paths_dropped"])
    live = sorted(growth.held.items(), key=lambda kv: kv[0][1])
    print(f"glass share of primary rays {share:.4f}; headroom 1 dropped "
          f"{dropped_h1} paths; growing queue lanes by bounce "
          f"{[v for _, v in live]}")

    paths = tuple(tuple(x) for x in cell["params"]["paths"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    target = torch.rand((3, h, w), generator=gen, device="cuda")
    init, step_fn = make_train_step(paths)
    steps, counts, peak = [], {}, 0
    for i in range(2):
        params = extract_params(scene, paths)
        torch.cuda.reset_peak_memory_stats()
        acc0 = accumulate.KERNELS["index_accumulate"].launches
        with counted(ci, counts) if i == 0 else contextlib.nullcontext():
            params, _, loss = step_fn(params, init(params), scene, target)
        torch.cuda.synchronize()
        if i == 0:
            counts["index_accumulate"] = (
                accumulate.KERNELS["index_accumulate"].launches - acc0)
            peak = torch.cuda.max_memory_allocated()
        steps.append([loss] + [t for v in params.values()
                               for t in (v.detach().clone(), v.grad.clone())])
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*steps)):
        raise AssertionError("repeat glass train steps differ")
    for t in steps[0][2::2]:
        if not bool(torch.isfinite(t).all()) or float(t.abs().sum()) == 0:
            raise AssertionError("a glass gradient is zero or not finite")
    # The closest walk on every bounce; no any hit (shadow rays skip the
    # glass, the only mesh).
    print(f"glass train step launches: {({k: n for k, n in counts.items() if n})}")
    if not counts.get("closest_hit") or counts.get("any_hit"):
        raise AssertionError(f"glass train step launches: {counts}")
    params = extract_params(scene, paths)
    state = init(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(2):
        params, state, _ = step_fn(params, state, scene, target)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 2
    out = {"wh": [w, h], "n_tris": int(desc["objects"][glass]["arrays"]
                                       ["v"].shape[0]),
           "glass_share": share, "headroom1_dropped": dropped_h1,
           "queue_lanes_by_bounce": [v for _, v in live],
           "step_dropped": growth.dropped, "launches": {
               k: n for k, n in counts.items() if n},
           "repeat_bit_equal": True, "peak_bytes": peak, "step_s": step_s,
           "phase_s": time.perf_counter() - t0}
    print(f"glass train step: {json.dumps(out)} on {card_line}")
    return out


@contextlib.contextmanager
def plain_prepass(ci):
    """`prepare` on the card with the plain pre-pass (`tile_tables` in
    PyTorch's kernels) in place of the pre-pass kernel."""
    def tables(aux, sbox, dist2):
        rows = aux.reshape(10, -1, ci.RAY_TILE).transpose(0, 1)
        return ci.tile_tables(rows[:, 0:3], rows[:, 6:9], rows[:, 9], sbox)

    saved = ci.prepass_kernel
    ci.prepass_kernel = tables
    try:
        yield
    finally:
        ci.prepass_kernel = saved


def syncs_in(fn) -> str:
    """"none" when fn() runs under PyTorch's sync debug mode "error"
    without a host sync, else the error's first line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return "none"


def prepass_phase(ci, card_line) -> tuple[dict, dict]:
    """Phase 42: the pre-pass kernel on the flagship's middle ray block
    (module docstring). Returns (numbers, the kernel table's row)."""
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.flagship import build_flagship_scene
    from rendering_tpu_torch.render.pipeline import render_scene

    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)
    kept: dict = {}
    counts: dict = {}
    with torch.no_grad(), keep_block(ci, n_blocks // 2, kept), \
            counted(ci, counts):
        render_scene(scene)
    check_launches(counts, {"closest_hit": n_blocks, "any_hit": n_blocks},
                   f"flagship render_scene ({n_blocks} ray blocks)")
    kernel = ci.KERNELS["prepass"]
    out: dict = {"frame_launches": counts["prepass"]}
    for anyhit, label in ((False, "primary"), (True, "shadow")):
        tb, prep = kept[anyhit]
        aux, n, cs = prep.aux, prep.n_rays, tb.sbox.shape[0]
        rows = aux.reshape(10, -1, ci.RAY_TILE).transpose(0, 1)
        args = (rows[:, 0:3], rows[:, 6:9], rows[:, 9], tb.sbox)
        dist2 = ci.super_dist2(rows[:, 0:3], rows[:, 9], tb.sbox).contiguous()
        want = ci.tile_tables(*args)
        got = kernel(aux, tb.sbox, dist2)
        if not (same(got, want) and same((prep.torder, prep.counts), want)):
            raise AssertionError(f"the pre-pass kernel ({label}) disagrees "
                                 f"with tile_tables")
        query = (tb, aux[0:3, :n], aux[3:6, :n], aux[9, :n])
        prepare_ms = mean_ms(lambda: ci.prepare(*query), reps=20)
        with plain_prepass(ci):
            plain_prepare_ms = mean_ms(lambda: ci.prepare(*query), reps=3)
            plain_syncs = syncs_in(lambda: ci.prepare(*query))
        held = int((aux[9] >= 0).sum()) + int(torch.isnan(aux[9]).sum())
        tests = prep.n_tiles * ci.RAY_TILE * cs
        n_bytes = sum(x.numel() * x.element_size()
                      for x in (aux, tb.sbox, dist2, *want))
        ops_ms = tests * PREPASS_SLAB_OPS / F32_OPS_RATE * 1e3
        bytes_ms = n_bytes / HBM_RATE * 1e3
        out[label] = {
            "tiles": prep.n_tiles, "supers": cs, "rays": n,
            "unresolved_rays": held, "slab_tests": tests,
            "live_supers_mean": float(want[1].double().mean()),
            "ms": mean_ms(lambda: kernel(aux, tb.sbox, dist2), reps=50),
            "dist2_ms": mean_ms(lambda: ci.super_dist2(
                rows[:, 0:3], rows[:, 9], tb.sbox), reps=20),
            "plain_ms": mean_ms(lambda: ci.tile_tables(*args), reps=3),
            "prepare_ms": prepare_ms, "plain_prepare_ms": plain_prepare_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "unresolved_bound_ms": (held * cs * PREPASS_SLAB_OPS
                                    / F32_OPS_RATE * 1e3),
            "syncs": syncs_in(lambda: ci.prepare(*query)),
            "plain_syncs": plain_syncs}
        print(f"pre-pass {label}: {json.dumps(out[label])}")
        if out[label]["syncs"] != "none":
            raise AssertionError(f"prepare synchronized: {out[label]['syncs']}")

    # The flagship train step with the plain pre-pass and with the kernel,
    # in turns (plain, kernel, kernel, plain), two timed steps each.
    flag = train(ci, scene, BENCH_PATHS, reps=2,
                 zero_ok=("lights/0/intensity", "obj_color"))
    check_launches(flag["launches"],
                   {"closest_hit": n_blocks, "any_hit": n_blocks},
                   "flagship train step")
    gen = torch.Generator(device=scene.device).manual_seed(0)
    st = scene.static.settings
    target = torch.rand((3, st.height, st.width), generator=gen,
                        device=scene.device)
    init, step_fn = make_train_step(BENCH_PATHS)
    steps = {True: [], False: []}
    for use_kernel in (False, True, True, False):
        with (contextlib.nullcontext() if use_kernel else plain_prepass(ci)):
            params = extract_params(scene, BENCH_PATHS)
            state = init(params)
            params, state, _ = step_fn(params, state, scene, target)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                params, state, _ = step_fn(params, state, scene, target)
            torch.cuda.synchronize()
            steps[use_kernel].append((time.perf_counter() - t0) / 2 * 1e3)
    out["step_launches"] = flag["launches"]["prepass"]
    out["step_ms"] = steps[True]
    out["plain_step_ms"] = steps[False]
    print(f"flagship train step with the pre-pass kernel "
          f"{steps[True]} ms, with the plain pre-pass {steps[False]} ms "
          f"(in turns) on {card_line}")
    row = {"name": "prepass", "route": "cuda", "source": SOURCE,
           "replaces": PREPASS_REPLACES,
           "launches": {"frame": out["frame_launches"],
                        "step": out["step_launches"]},
           "max_abs_err": 0.0, "ms": out["primary"]["ms"],
           "plain_ms": out["primary"]["plain_ms"],
           "bound_ms": out["primary"]["bound_ms"],
           "bound_by": out["primary"]["bound_by"], "library_ms": None}
    del scene
    torch.cuda.empty_cache()
    return out, row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from rendering_tpu_torch.flagship import (
        build_flagship_scene,
        build_multimesh_scene,
        build_tiny_scene,
    )
    from rendering_tpu_torch import native
    from rendering_tpu_torch.ops import accumulate
    from rendering_tpu_torch.ops import cuda_intersect as ci
    from rendering_tpu_torch.ops import microbench as mb
    from rendering_tpu_torch.ops import traversal
    import numpy as np

    from rendering_tpu_torch.render import pipeline as render_pipeline
    from rendering_tpu_torch.render.pipeline import render_scene
    from rendering_tpu_torch.utils import nvcc

    if not native.enabled():
        raise AssertionError("RTPU_NATIVE=0 is set: the port's C++ host "
                             "runtime must run here")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = describe_card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line)
    lap = Laps()

    # ---- build: one nvcc per source and g++ for the host runtime, all
    # started together ------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = list(pool.map(nvcc.build_library,
                              (ci.SOURCE, mb.SOURCE, traversal.SOURCE,
                               native.SOURCE, accumulate.SOURCE)))
    if native.get_lib() is None:
        raise AssertionError("the host runtime did not load")
    for path, log in built:
        print(f"built {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  ptxas:", line.strip())
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["42"]:
        numbers, row = prepass_phase(ci, card_line)
        lap("42 pre-pass kernel")
        print(json.dumps({"prepass": numbers, "phase_s": lap.laps}))
        print(json.dumps({"kernels": [row]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["41"]:
        glass = glass_train_phase(ci, card_line)
        lap("41 glass train step")
        print(json.dumps({"glass_train": glass, "phase_s": lap.laps}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    scene = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    torch.cuda.synchronize()
    tb = scene.meshes[0].itables
    print(f"flagship scene {N_TRIS} triangles at {WIDTH}x{HEIGHT} built in "
          f"{time.perf_counter() - t0:.1f} s; tables tc={tb.tri_chunk} "
          f"n_sub={tb.n_sub} Cs={tb.sbox.shape[0]}")
    bfc = scene.static.settings.use_backface_culling
    n_blocks = -(-WIDTH * HEIGHT // RAY_BLOCK)

    lap("build")

    # ---- 1. flagship forward render through render_scene -------------------
    kept: dict = {}
    fwd_counts: dict = {}
    with torch.no_grad(), keep_block(ci, n_blocks // 2, kept), \
            counted(ci, fwd_counts):
        frame3, _ = render_scene(scene)
    check_launches(fwd_counts, {"closest_hit": n_blocks, "any_hit": n_blocks},
                   f"flagship render_scene ({n_blocks} ray blocks)")
    check_frame(scene, frame3, WIDTH, HEIGHT, "flagship")
    # Phases 35-36's references: this frame, phase 5's gradients, phase
    # 6's frame.
    os.makedirs(MD_DIR, exist_ok=True)
    np.save(md_file("flag_f32.npy"), frame3.cpu().numpy())
    np.save(md_file("flag_u8.npy"), render_pipeline.quantize_u8(frame3)
            .cpu().numpy())

    def forward():
        with torch.no_grad():
            render_scene(scene)

    frame_ms = mean_ms(forward, reps=3)
    rays = WIDTH * HEIGHT
    print(f"forward frame {WIDTH}x{HEIGHT}, {N_TRIS} triangles: "
          f"{frame_ms:.3f} ms, {rays / frame_ms * 1e3:.4e} rays/s "
          f"(CUDA events, mean of 3 after 1 warm-up) on {card_line}")

    lap("1 flagship forward")

    # ---- 2-3. K1, K2 vs plain, and their numbers, on the kept queries ------
    err, nums = {}, {}
    for name in ("closest_hit", "any_hit"):
        err[name] = check_parity(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
    for name in ("closest_hit", "any_hit"):
        nums[name] = kernel_numbers(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()

    lap("2-3 K1/K2 vs plain")

    # ---- 4. flagship whole-render parity ------------------------------------
    whole_render_parity(
        ci, lambda w, h: build_flagship_scene(w, h, n_tris=N_TRIS), "flagship")

    lap("4 flagship parity")

    # ---- 5. flagship fwd+bwd train step --------------------------------------
    flag_grads: dict = {}
    flag = train(ci, scene, BENCH_PATHS, reps=3,
                 zero_ok=("lights/0/intensity", "obj_color"),
                 kept=flag_grads)
    np.savez(md_file("flag_grads.npz"),
             **{k.replace("/", "|"): v for k, v in flag_grads.items()})
    del flag_grads
    check_launches(flag["launches"],
                   {"closest_hit": n_blocks, "any_hit": n_blocks},
                   "flagship train step")
    print(f"flagship fwd+bwd step {WIDTH}x{HEIGHT}: {flag['step_ms']:.3f} ms, "
          f"{flag['rays_per_s']:.4e} rays/s; peak "
          f"{flag['peak_bytes'] / 2**30:.3f} GiB on {card_line}")
    del scene, frame3
    torch.cuda.empty_cache()

    lap("5 flagship train step")

    # ---- 6. 16-mesh forward render (K5) --------------------------------------
    t0 = time.perf_counter()
    mm = build_multimesh_scene(MM_WIDTH, MM_HEIGHT, n_meshes=MM_MESHES,
                               tris_per_mesh=MM_TRIS_PER_MESH)
    torch.cuda.synchronize()
    ft = mm.fused_itables
    print(f"multimesh scene {MM_MESHES} x {MM_TRIS_PER_MESH} triangles at "
          f"{MM_WIDTH}x{MM_HEIGHT} built in {time.perf_counter() - t0:.1f} s; "
          f"fused tables tc={ft.geo.tri_chunk} Cs={ft.geo.sbox.shape[0]}")
    mm_blocks = -(-MM_WIDTH * MM_HEIGHT // RAY_BLOCK)
    bfc = mm.static.settings.use_backface_culling
    mm_counts: dict = {}
    with torch.no_grad(), keep_block(ci, mm_blocks // 2, kept), \
            counted(ci, mm_counts):
        mm_frame, _ = render_scene(mm)
    check_launches(mm_counts, {"fused_closest_hit": mm_blocks,
                               "fused_any_hit": mm_blocks},
                   f"multimesh render_scene ({mm_blocks} ray blocks)")
    check_frame(mm, mm_frame, MM_WIDTH, MM_HEIGHT, "multimesh")
    np.save(md_file("mm_u8.npy"), render_pipeline.quantize_u8(mm_frame)
            .cpu().numpy())

    def mm_forward():
        with torch.no_grad():
            render_scene(mm)

    mm_frame_ms = mean_ms(mm_forward, reps=3)
    print(f"multimesh forward frame: {mm_frame_ms:.3f} ms on {card_line}")

    lap("6 multimesh forward")

    # ---- 7. K5 vs plain, and its numbers, on the kept queries -----------------
    for name in ("fused_closest_hit", "fused_any_hit"):
        err[name] = check_parity(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
    for name in ("fused_closest_hit", "fused_any_hit"):
        nums[name] = kernel_numbers(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()

    lap("7 K5 vs plain")

    # ---- 8. multimesh whole-render parity ------------------------------------
    whole_render_parity(
        ci, lambda w, h: build_multimesh_scene(
            w, h, n_meshes=MM_MESHES, tris_per_mesh=MM_TRIS_PER_MESH),
        "multimesh")

    lap("8 multimesh parity")

    # ---- 9. multimesh fwd+bwd train step ------------------------------------
    mmt = train(ci, mm, MM_PATHS, reps=3)
    check_launches(mmt["launches"], {"fused_closest_hit": mm_blocks,
                                     "fused_any_hit": mm_blocks},
                   "multimesh train step")
    print(f"multimesh fwd+bwd step {MM_WIDTH}x{MM_HEIGHT}: "
          f"{mmt['step_ms']:.3f} ms, {mmt['rays_per_s']:.4e} rays/s; peak "
          f"{mmt['peak_bytes'] / 2**30:.3f} GiB on {card_line}")

    del mm, mm_frame
    torch.cuda.empty_cache()

    lap("9 multimesh train step")

    # ---- 10. the scene file through the CLI (K4) -----------------------------
    from rendering_tpu_torch.flagship import procedural_mesh
    from rendering_tpu_torch.models.objloader import write_obj

    os.makedirs(WORKSPACE, exist_ok=True)
    t0 = time.perf_counter()
    objs = {}
    for key, n, seed in (("shotgun", N_TRIS, 0), ("two_a", TWO_OBJ_TRIS[0], 1),
                         ("two_b", TWO_OBJ_TRIS[1], 2)):
        m = procedural_mesh(n, pos=(0, 0, 0), size=(2, 2, 2), seed=seed)
        objs[key] = os.path.join(WORKSPACE, f"{key}.obj")
        write_obj(objs[key], m.v, m.uv, m.n)
    write_s = time.perf_counter() - t0
    print(f"wrote the OBJ files {[os.path.getsize(p) for p in objs.values()]} "
          f"bytes in {write_s:.3f} s")
    scene_paths = {}
    for stats in (False, True):
        scene_paths[stats] = os.path.join(WORKSPACE, f"shotgun{int(stats)}.scene")
        write_scene(scene_paths[stats], objs["shotgun"], w=SCENE_W, h=SCENE_H,
                    stats=stats, name=f"shotgun{int(stats)}")
        scene_paths["two", stats] = os.path.join(WORKSPACE,
                                                 f"two{int(stats)}.scene")
        write_scene(scene_paths["two", stats], objs["two_a"], w=TWO_OBJ_WH[0],
                    h=TWO_OBJ_WH[1], stats=stats, name=f"two{int(stats)}",
                    second_obj=objs["two_b"])

    sf_block = math.ceil(SCENE_W * SCENE_H / RAY_BLOCK) // 2
    two_block = math.ceil(TWO_OBJ_WH[0] * TWO_OBJ_WH[1] / RAY_BLOCK) // 2
    sf = cli_path(ci, scene_paths[False], "scene file", kept, sf_block)
    scene = sf["scene"]
    bfc = scene.static.settings.use_backface_culling
    if not sf["clipped"][0]:
        raise AssertionError("the scene file's mesh is not clipped")

    def sf_forward(sc):
        with torch.no_grad():
            render_scene(sc)

    sf_frame_ms = mean_ms(lambda: sf_forward(scene), reps=2)
    print(f"scene-file frame {SCENE_W}x{SCENE_H} (primary + SSAA): "
          f"{sf_frame_ms:.3f} ms on {card_line}")
    turns = native_turns(ci, scene_paths[False], card_line)

    lap("10 scene file")

    # ---- 11. K4 vs plain, and its numbers, on the kept queries ---------------
    for name in ("closest_hit_rootfilter", "any_hit_rootfilter"):
        err[name] = check_parity(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
        nums[name] = kernel_numbers(ci, name, *kept[ci.KERNELS[name].anyhit],
                                    bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()

    lap("11 K4 vs plain")

    # ---- 12. collectStatistics=1 through the CLI (K3 with K4) ----------------
    sfs = cli_path(ci, scene_paths[True], "scene file, collectStatistics=1",
                   kept, sf_block)
    for name in ("closest_hit_rootfilter_stats", "any_hit_rootfilter_stats"):
        err[name] = check_parity(ci, name, *kept[ci.KERNELS[name].anyhit], bfc)
        nums[name] = kernel_numbers(ci, name, *kept[ci.KERNELS[name].anyhit],
                                    bfc)
        print(f"{name}: {json.dumps(nums[name])}")
    kept.clear()
    sfs_frame_ms = mean_ms(lambda: sf_forward(sfs["scene"]), reps=2)
    print(f"counting frame {SCENE_W}x{SCENE_H}: {sfs_frame_ms:.3f} ms vs "
          f"{sf_frame_ms:.3f} ms without the counters on {card_line}")

    lap("12 collectStatistics=1")

    # ---- 13. whole-render parity; the two-OBJ scene file (K5 + K4 + K3) -------
    whole_render_parity(ci, lambda w, h: scene_at(sfs["scene_def"], w, h),
                        "scene file, SSAA, collectStatistics=1")
    del scene, sf["scene"], sfs["scene"]
    torch.cuda.empty_cache()
    two = {}
    for stats in (False, True):
        two[stats] = cli_path(ci, scene_paths["two", stats],
                              f"two-OBJ scene file (stats {int(stats)})",
                              kept, two_block)
        if two[stats]["clipped"] != [True, False]:
            raise AssertionError("the two-OBJ scene: expected one clipped mesh")
        sfx = "_rootfilter" + ("_stats" if stats else "")
        for name in (f"fused_closest_hit{sfx}", f"fused_any_hit{sfx}"):
            err[name] = check_parity(ci, name,
                                     *kept[ci.KERNELS[name].anyhit], bfc)
            nums[name] = kernel_numbers(ci, name,
                                        *kept[ci.KERNELS[name].anyhit], bfc)
            print(f"{name}: {json.dumps(nums[name])}")
        kept.clear()
    whole_render_parity(ci, lambda w, h: scene_at(two[True]["scene_def"], w, h),
                        "two-OBJ scene file, SSAA, collectStatistics=1")
    two_nums = {k: path_numbers(v) for k, v in two.items()}

    lap("13 parity, two-OBJ scene file")
    del two
    torch.cuda.empty_cache()

    # ---- 14. the bouncing frame: all four materials (K1, K2) ---------------
    from rendering_tpu_torch.render import integrator as it

    t0 = time.perf_counter()
    tiny = build_tiny_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    torch.cuda.synchronize()
    tiny_build_s = time.perf_counter() - t0
    bfc = tiny.static.settings.use_backface_culling
    n_bounces = tiny.static.settings.max_ray_depth + 1
    lanes = n_blocks * min(RAY_BLOCK, WIDTH * HEIGHT)
    shadow_call: dict = {}
    bounces: list = []
    b_counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), counted(ci, b_counts), \
            kept_call(ci, "any_hit", 2 * (n_blocks // 2), shadow_call), \
            timed_bounces(it, bounces):
        b_frame, b_aux = render_scene(tiny)
    b_peak = torch.cuda.max_memory_allocated()
    check_launches(b_counts, {"closest_hit": n_blocks * n_bounces,
                              "any_hit": 2 * n_blocks * n_bounces},
                   f"bouncing render_scene ({n_bounces} bounces of "
                   f"{n_blocks} ray blocks)")
    check_frame(tiny, b_frame, WIDTH, HEIGHT, "bouncing")
    b_stats = {k: int(v) for k, v in b_aux["stats"].items()}
    want_rays = expected_rays(tiny, lanes)
    print(f"bouncing frame: scene built in {tiny_build_s:.1f} s; stats "
          f"{b_stats}; rays_casted by the JAX formula {want_rays} "
          f"({n_bounces} bounces x {lanes} lanes x (1 + shadow rays)); "
          f"peak {b_peak / 2**30:.3f} GiB; bounces (synchronized) "
          f"{bounces}")
    if b_stats["rays_casted"] != want_rays or b_stats["paths_dropped"]:
        raise AssertionError("bouncing frame: rays_casted or paths_dropped")

    def tiny_forward():
        with torch.no_grad():
            render_scene(tiny)

    b_frame_ms = mean_ms(tiny_forward, reps=2)
    print(f"bouncing frame {WIDTH}x{HEIGHT}, {N_TRIS} triangles: "
          f"{b_frame_ms:.3f} ms (CUDA events, mean of 2 after 1 warm-up) on "
          f"{card_line}")
    del b_frame
    # Three of the frame's shadow queries and two of its closest hits,
    # each held to the plain version.
    kept_b, kept_c = bouncing_queries(ci, tiny, n_blocks)
    b_queries = {}
    for key, q in kept_b.items():
        b_queries[key] = kernel_numbers(ci, "any_hit", *q, bfc)
        print(f"any_hit, bouncing {key}: {json.dumps(b_queries[key])}")
    b_closest = {}
    for key, q in kept_c.items():
        b_closest[key] = kernel_numbers(ci, "closest_hit", *q, bfc)
        print(f"closest_hit, bouncing {key}: {json.dumps(b_closest[key])}")
    del kept_b, kept_c
    lap("14 bouncing frame")

    # ---- 15. bouncing whole-render parity, single pass and K6 ---------------
    b_parity = {}
    for frac in (0.0, FRACS[-1]):
        b_parity[frac], _ = whole_render_parity(
            ci, lambda w, h, f=frac: build_tiny_scene(
                w, h, n_tris=N_TRIS, settings_overrides=dict(
                    enable_ssaa=True, collect_statistics=True,
                    anyhit_compact_frac=f)),
            f"bouncing, SSAA, collectStatistics=1, anyhit_compact_frac={frac}")
    frac_equal = torch.equal(b_parity[0.0], b_parity[FRACS[-1]])
    print(f"bouncing frame at anyhit_compact_frac={FRACS[-1]} bit-equal to "
          f"the single-pass frame: {frac_equal}")
    if not frac_equal:
        raise AssertionError("the two-phase render differs from the "
                             "single-pass render")
    lap("15 bouncing parity")

    # ---- 16. K6 vs plain, and its numbers, on the kept shadow query ---------
    tb, ro3, rd3, t_lim = shadow_call["args"]
    k6_err = 0.0
    for collect in (False, True):
        for frac in FRACS:
            kw = dict(frac=frac, backface_culling=bfc, collect_stats=collect)
            out_k = ci.any_hit_two_phase(tb, ro3, rd3, t_lim, **kw)
            with plain_queries(ci):
                out_p = ci.any_hit_two_phase(tb, ro3, rd3, t_lim, **kw)
            out_k = out_k if collect else (out_k,)
            out_p = out_p if collect else (out_p,)
            single = ci.any_hit(tb, ro3, rd3, t_lim, backface_culling=bfc)
            mis = int((out_k[0] != out_p[0]).sum())
            k6_err = max(k6_err, float((out_k[0].float()
                                        - out_p[0].float()).abs().max()))
            mis_single = int((out_k[0] != single).sum())
            counters = ([int(x) for x in out_k[1:]], [int(x) for x in out_p[1:]])
            print(f"parity any_hit_two_phase frac={frac} stats={collect}: "
                  f"{ro3.shape[1]} rays, {int(out_k[0].sum())} occluded; "
                  f"mismatches vs plain {mis}, vs single pass {mis_single}; "
                  f"counters kernel {counters[0]} plain {counters[1]}")
            if mis or mis_single or counters[0] != counters[1]:
                raise AssertionError("K6 disagrees with its plain version")
    k6 = {frac: two_phase_numbers(ci, tb, ro3, rd3, t_lim, frac, bfc)
          for frac in FRACS}
    for frac, n in k6.items():
        print(f"any_hit_two_phase frac={frac}: {json.dumps(n)}")
    k2_same = dict(b_queries["bounce0_point_distant"])  # the same query
    k2_same["call_ms"] = mean_ms(lambda: ci.any_hit(
        tb, ro3, rd3, t_lim, backface_culling=bfc), reps=5)
    print(f"any_hit (single pass) on the same query: {json.dumps(k2_same)}")
    nums["any_hit_two_phase"] = k6[FRACS[-1]]
    err["any_hit_two_phase"] = k6_err
    del shadow_call, tb, ro3, rd3, t_lim
    lap("16 K6 vs plain")

    # ---- 17. flagship fwd+bwd step at anyhit_compact_frac 0, 0.25, 0.5 ------
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )

    flagship = build_flagship_scene(WIDTH, HEIGHT, n_tris=N_TRIS)
    target = train_target(flagship)
    frac_steps = {}
    first = None
    for frac in (0.0, *FRACS):
        sc = with_settings(flagship, anyhit_compact_frac=frac)
        init, step_fn = make_train_step(BENCH_PATHS)
        counts: dict = {}
        with counted(ci, counts):
            params = extract_params(sc, BENCH_PATHS)
            params, _, loss = step_fn(params, init(params), sc, target)
        out = [loss] + [v.grad.clone() for v in params.values()]
        check_launches(counts, {"closest_hit": n_blocks,
                                ("any_hit_two_phase" if frac else "any_hit"):
                                n_blocks * (2 if frac else 1)},
                       f"flagship train step, anyhit_compact_frac={frac}")
        if first is None:
            first = out
        elif not all(torch.equal(a, b) for a, b in zip(first, out)):
            raise AssertionError(f"the step at anyhit_compact_frac={frac} "
                                 f"differs from the single-pass step")
        params = extract_params(sc, BENCH_PATHS)
        state = init(params)
        step_fn(params, state, sc, target)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step_fn(params, state, sc, target)
        torch.cuda.synchronize()
        frac_steps[frac] = {"step_ms": (time.perf_counter() - t0) / 2 * 1e3,
                            "launches": {k: n for k, n in counts.items() if n}}
        print(f"flagship fwd+bwd step at anyhit_compact_frac={frac}: "
              f"{frac_steps[frac]['step_ms']:.3f} ms (mean of 2 after 1 "
              f"warm-up); loss and gradients bit-equal to frac 0 on "
              f"{card_line}")
    k6_launches = frac_steps[FRACS[-1]]["launches"]["any_hit_two_phase"]
    del flagship, sc, params, state, first, out
    torch.cuda.empty_cache()
    lap("17 flagship step at each frac")

    # ---- 18. the bouncing train step ------------------------------------------
    b_train = train(ci, tiny, TINY_PATHS, reps=1)
    # The train step renders inside `integrator.growing_queue`:
    # every ray block on bounce 0, then only the blocks that hold live
    # children, at least one a bounce; two shadow queries a traced block.
    closest_n = b_train["launches"].get("closest_hit", 0)
    if not n_blocks + n_bounces - 1 <= closest_n <= n_blocks * n_bounces:
        raise AssertionError(f"bouncing train step: {closest_n} closest hits "
                             f"for {n_blocks} blocks and {n_bounces} "
                             f"bounces")
    check_launches(b_train["launches"],
                   {"closest_hit": closest_n, "any_hit": 2 * closest_n},
                   "bouncing train step")
    print(f"bouncing fwd+bwd step {WIDTH}x{HEIGHT}: "
          f"{b_train['step_ms']:.3f} ms; peak "
          f"{b_train['peak_bytes'] / 2**30:.3f} GiB on {card_line}")
    del tiny
    torch.cuda.empty_cache()
    lap("18 bouncing train step")

    # ---- 19. t01_simple_shapes.scene through cli.main, against its golden ---
    import numpy as np

    from rendering_tpu_torch import cli
    from rendering_tpu_torch.render import pipeline
    from rendering_tpu_torch.utils.bmp import bmp_to_image, load_bmp

    t01_bmp = os.path.join(WORKSPACE, "t01.bmp")
    t01_renders: list = []
    with recorded(pipeline, "render_scene", t01_renders):
        cli.main([os.path.join(TESTS, "scenes", "t01_simple_shapes.scene"),
                  "--output", t01_bmp])
    t01_dropped = [int(c["result"][1]["stats"]["paths_dropped"])
                   for c in t01_renders]
    t01 = golden_measures(
        bmp_to_image(load_bmp(t01_bmp)),
        bmp_to_image(load_bmp(os.path.join(TESTS, "goldens",
                                           "t01_simple_shapes.bmp"))))
    print(f"t01_simple_shapes through cli.main: measures {t01} (limits "
          f"{T01_TOL}); paths_dropped per render {t01_dropped}; render "
          f"{[c['s'] for c in t01_renders]} s")
    if any(m > t for m, t in zip(t01, T01_TOL)) or any(t01_dropped):
        raise AssertionError("t01 is outside its golden tolerance")
    lap("19 t01 cli")

    # ---- 20-21. the hardware-ceiling probes (K7-K9) through their tools ------
    probe_rows, vpu = fma_phase(ci, mb, card_line)
    lap("20 K7 f32 rates, HBM (microbench_vpu_torch)")
    rows_k, kprobe = kernel_probe_phase(ci, mb, card_line)
    probe_rows += rows_k
    lap("21 K8 grid, K9 pair product (microbench_kernel_torch)")
    shares = ceiling_report(nums, vpu["rates"], card_line)

    # ---- 22. adversarial shadow queries on both any-hit walks ---------------
    adv = build_flagship_scene(64, 32, n_tris=ADVERSARIAL_TRIS)
    adversarial = adversarial_phase(
        ci, adv.meshes[0].itables, adv.static.settings.use_backface_culling,
        bias=adv.static.settings.bias)
    del adv
    lap("22 adversarial shadow queries")

    # ---- 23. a transparent mesh beside an opaque one --------------------------
    transparent = transparent_phase(ci)
    lap("23 transparent mesh")

    # ---- 24. outputProgress=1 through the CLI: the strip renderer ----------
    progress, prog_scene, strip_frame = progress_phase(
        ci, objs["shotgun"], scene_paths[False][:-len(".scene")] + ".bmp",
        card_line)
    lap("24 outputProgress=1 cli")

    # ---- 25. render_resumable: checkpoints, resume, a stale checkpoint ----
    resumable = resumable_phase(prog_scene, strip_frame, card_line)
    del prog_scene, strip_frame
    torch.cuda.empty_cache()
    lap("25 resumable")

    # ---- 26. showNormals through the CLI (closest hits only) ---------------
    normals = show_normals_phase(ci, objs["shotgun"], card_line)
    torch.cuda.empty_cache()
    lap("26 showNormals cli")

    # ---- 27. showAC through the CLI: the walk's kernel against the plain ----
    show_ac, ac_row = show_ac_phase(ci, objs["shotgun"], card_line)
    torch.cuda.empty_cache()
    lap("27 showAC cli")

    # ---- 28-31. the inverse-rendering extras ----------------------------------
    paint = texture_paint_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("28 texture paint")
    pose = camera_pose_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("29 camera pose")
    turntable = turntable_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("30 turntable")
    traced = trace_phase(ci, scene_paths[False], card_line)
    lap("31 --trace-dir")

    # ---- 32-33. real geometry and the 16-mesh scene from OBJ files ----------
    real = real_geometry_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("32 real-geometry flagship")
    bunny = bunny_grid_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("33 16-mesh scene from OBJ")

    # ---- 34-37. several ranks: NCCL with one rank, then MD_RANKS ranks ------
    md = multidevice_phase(ci, card_line)
    lap(f"34-37 multi-device ({md['label']})")

    # ---- 38-39. the oracles without the mesh kernels ----------------------
    bvh, bvh_row = bvh_flagship_phase(ci, card_line, flag["loss"])
    lap("38 BVH-walk flagship")
    dense = dense_multimesh_phase(ci, card_line)
    torch.cuda.empty_cache()
    lap("39 dense multimesh")
    accum = index_accumulate_phase(card_line)
    lap("40 index accumulation")
    glass = glass_train_phase(ci, card_line)
    lap("41 glass train step")
    prepass, prepass_row = prepass_phase(ci, card_line)
    lap("42 pre-pass kernel")

    # ---- report ----------------------------------------------------------------
    launches = {**flag["launches"], **{
        k: mmt["launches"][k] for k in ("fused_closest_hit", "fused_any_hit")},
        "any_hit_two_phase": k6_launches}
    for run in (sf, sfs, two_nums[False], two_nums[True]):
        launches.update(run["launches"])
    rows = []
    for name, n in nums.items():
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces(name),
            "launches": launches[name], "max_abs_err": err[name],
            "ms": n["ms"], "plain_ms": n["plain_ms"],
            "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
            "library_ms": None,
        }
        if name in ("closest_hit", "any_hit"):
            # The inverse-rendering extras' paths launch K1 and K2 too.
            row["launches_by_path"] = {
                "texture_paint_step": paint["launches"][name],
                "camera_pose_step": pose["launches"][name],
                "turntable": turntable["launches"][name]}
        for path, run in (("real_geometry_frame", real["launches"]),
                          ("real_geometry_step", real["fwd_bwd"]["launches"]),
                          ("bunny_grid_frame", bunny["launches"]),
                          ("bunny_grid_step", bunny["fwd_bwd"]["launches"])):
            if run.get(name):
                row.setdefault("launches_by_path", {})[path] = run[name]
        if any(t["launches"].get(name) for t in turns["turns"]):
            row.setdefault("launches_by_path", {})["scene_file_turns"] = [
                t["launches"].get(name, 0) for t in turns["turns"]]
        # The multi-device paths: one count for each rank.
        for path, key, sub in (
                ("sharded_flagship_frame", "flagship", "frame_launches"),
                ("sharded_flagship_step", "flagship", "step_launches"),
                ("geo_sharded_multimesh_frame", "geo", "launches"),
                ("sharded_cli_progress", "cli", "launches"),
                ("geo_sharded_cli_progress", "cli_geo", "launches")):
            per_rank = [r[key][sub].get(name, 0) for r in md["per_rank"]]
            if any(per_rank):
                row.setdefault("launches_by_path", {})[path] = per_rank
        rows.append(row)
    rows += probe_rows
    rows.append({"name": "ac_walk", "route": "cuda", "source": AC_SOURCE,
                 "replaces": AC_REPLACES, **ac_row, "library_ms": None})
    rows.append({"name": "bvh_closest", "route": "cuda", "source": AC_SOURCE,
                 "replaces": BVH_REPLACES, **bvh_row, "library_ms": None})
    rows.append({"name": "index_accumulate", "route": "cuda",
                 "source": ACCUM_SOURCE, "replaces": ACCUM_REPLACES,
                 "launches": {"frame": accum["frame_launches"],
                              "step": accum["step_launches"]},
                 **accum["calls"]})
    rows.append(prepass_row)

    print(json.dumps({
        "card": card_line,
        "flagship": {"frame_ms": frame_ms,
                     "rays_per_s": rays / frame_ms * 1e3,
                     "fwd_bwd": flag},
        "multimesh": {"frame_ms": mm_frame_ms, "fwd_bwd": mmt},
        "scene_file": {"obj_write_s": write_s, "frame_ms": sf_frame_ms,
                       "stats_frame_ms": sfs_frame_ms,
                       "cli": path_numbers(sf), "cli_stats": path_numbers(sfs),
                       "two_obj": two_nums[False],
                       "two_obj_stats": two_nums[True],
                       "native_turns": turns},
        "real_geometry": real, "bunny_grid": bunny,
        "bouncing": {"frame_ms": b_frame_ms, "stats": b_stats,
                     "peak_bytes": b_peak, "bounces": bounces,
                     "fwd_bwd": b_train, "k6": k6, "k2_same_query": k2_same,
                     "anyhit_queries": b_queries,
                     "closest_queries": b_closest,
                     "adversarial": adversarial, "transparent": transparent,
                     "flagship_steps_by_frac": frac_steps,
                     "t01": {"measures": t01, "dropped": t01_dropped}},
        "progress": progress, "resumable": resumable,
        "show_normals": normals, "show_ac": show_ac,
        "texture_paint": paint, "camera_pose": pose, "turntable": turntable,
        "trace": traced, "multidevice": md,
        "bvh_flagship": bvh, "dense_multimesh": dense,
        "index_accumulate": accum, "glass_train": glass, "prepass": prepass,
        "probes": {"vpu": vpu["rates"], "kernel": kprobe["summary"],
                   "k1_k6_shares": shares},
        "phase_s": lap.laps,
    }))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
