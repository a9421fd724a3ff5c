"""Ray sharding: the scene replicated on every rank, the rays of a frame
split over the ranks — the port of `rendering_tpu.parallel.shard` on
torch.distributed, one process per rank.

* Primary pass: the frame's pixels in the 2-D screen-tile order of the
  single-device pass, cut into ndev * k tiles of TILE_PX pixels dealt
  round-robin (`_round_robin_layout`); each rank integrates its slots
  with no communication until one all-gather assembles the slots, and
  `unpermute_slots` undoes the layout with reshapes, no scatter. Every
  rank then holds the whole frame, as the JAX package's replicated
  output.
* Adaptive SSAA: the Sobel mask of the replicated frame, the compacted
  edge pixels split evenly over the ranks, each rank's refined pixels
  added into a (3, H*W) accumulator, and one SUM all-reduce of it.
* Gradients: the slots' all-gather hands each rank its slice of the
  cotangent and the SSAA all-reduce the cotangent itself
  (`parallel.collectives`), so each rank's parameter gradients are its
  share of the loss's; the train step sums them over the ranks
  (`parallel.overlap`).
* Counters are summed over the ranks. They count the padded duplicate
  slots, as the block padding of the single-device paths.

The functions take a mesh with a `rays` axis (`collectives.Comm`), so the
geometry-sharded renderer (`parallel.geoshard`) runs them on each rank's
local scene, whose trace combines over its geo axis. Frames are
channel-first (3, H, W) tensors on the mesh's device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from rendering_tpu_torch.ops.accumulate import index_accumulate
from rendering_tpu_torch.ops.sobel import sobel_mask
from rendering_tpu_torch.ops.traversal import count_ac_nodes
from rendering_tpu_torch.parallel import collectives
from rendering_tpu_torch.parallel.collectives import Comm
from rendering_tpu_torch.render.integrator import (
    DEFAULT_RAY_BLOCK,
    integrate,
    shade_normals,
    zero_stats,
)
from rendering_tpu_torch.render.raygen import (
    pixel_dirs,
    ssaa_subsample_rays,
    tile_dims,
)


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of ranks with the ray axis: this rank's view of it
    (`rays`, a `collectives.Comm`) and its device. `all` is the axis of
    every rank of the mesh (the ray axis itself)."""

    rays: Comm
    device: torch.device
    axis_names = ("rays",)

    @property
    def all(self) -> Comm:
        return self.rays


def comm_for(group) -> Comm:
    """This rank's Comm on `group` (None: the default group; one rank
    or no process group: the axis of one)."""
    if not dist.is_initialized():
        return collectives.single()
    size = dist.get_world_size(group)
    if size == 1:
        return collectives.single()
    return Comm(group, dist.get_rank(group), size)


def make_ray_mesh(group=None, device=None) -> RayMesh:
    """The ray mesh over `group`'s ranks (default: every rank; without a
    process group, this process alone) on this rank's device
    (`multihost.rank_device`)."""
    from rendering_tpu_torch.parallel.multihost import rank_device

    dev = rank_device(device)
    return RayMesh(comm_for(group), dev)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# Pixels per screen tile of the round-robin interleave: big enough to keep
# each rank's rays coherent for the kernels' tile pre-cull, small enough
# that an expensive screen region (glass, deep bounces) spreads over the
# ranks instead of landing on one.
TILE_PX = 16384


def _round_robin_layout(r: int, ndev: int, wh=None, *, device=None):
    """Screen-tile round-robin layout (JAX `_round_robin_layout`):
    n_tiles = ndev * k tiles of rp / n_tiles pixels, rank d taking tiles
    d, d + ndev, ... Returns (rp, perm) with perm (rp,) int32: perm[k] is
    the pixel of global slot k (slots contiguous per rank).

    wh = (w, h) with w * h == r orders the pixels by the single-device
    pass's 2-D screen tiles (raygen.tile_dims rects) before the
    interleave, so each 512-ray kernel tile covers a compact screen rect.
    Without it a kernel tile is a 512-pixel scanline run whose thin
    frustum keeps ~5x more super chunks live: the JAX package measured
    the sharded 250k flagship at 5.8 against 1.1 M rays/s at 1920x1080
    (`rendering_tpu/parallel/shard.py:80-91`)."""
    k = max(1, -(-r // (ndev * TILE_PX)))
    n_tiles = ndev * k
    rp = _pad_to(r, n_tiles)
    tile = rp // n_tiles

    def arange(lo, hi, step=1):
        return torch.arange(lo, hi, step, dtype=torch.int32, device=device)

    if wh is not None and wh[0] * wh[1] == r:
        w, h = wh
        tw, th = tile_dims(w, h)
        s = arange(0, r)
        tile_id, within = s // (tw * th), s % (tw * th)
        ty, tx = within // tw, within % tw
        tiles_x = w // tw
        x = (tile_id % tiles_x) * tw + tx
        y = (tile_id // tiles_x) * th + ty
        base = torch.cat([y * w + x, arange(r, rp)])
    else:
        base = arange(0, rp)
    tiles = base.reshape(n_tiles, tile)
    order = torch.cat([arange(d, n_tiles, ndev) for d in range(ndev)])
    return rp, tiles[order.long()].reshape(-1)


def _local(perm, comm: Comm):
    """This rank's contiguous block of global slots."""
    n = perm.shape[0] // comm.size
    return perm[comm.rank * n:(comm.rank + 1) * n]


def _integrate_slots_sharded(scene, mesh, xs, ys, *, ray_block,
                             queue_headroom: int = 1):
    """The slot integration shared by the primary and strip passes: this
    rank integrates the primary rays of its (xs, ys) (its block of
    slots) with identity pixel ids. Returns (accum3 (3, rp) in global
    slot order, all-gathered with `collectives.gather_slots`; the
    counters summed over the ranks). showNormals reports no counters;
    its callers set the true ray count."""
    st = scene.static
    rd = pixel_dirs(scene, xs, ys, 1.0, 1.0)
    ro = scene.cam_pos.expand(rd.shape)
    nloc = xs.shape[0]
    if st.settings.show_normals:
        accum3 = shade_normals(scene, ro, rd, ray_block=ray_block)
        stats = zero_stats()
    else:
        accum3, stats = integrate(
            scene, ro, rd, torch.arange(nloc, dtype=torch.int32,
                                        device=xs.device),
            torch.ones((nloc,), device=xs.device), nloc,
            ray_block=ray_block, out_slots=not st.any_bouncing,
            queue_headroom=queue_headroom)
    return (collectives.gather_slots(mesh.rays, accum3),
            collectives.all_reduce_stats(mesh.rays, stats))


def unpermute_slots(accum3, r: int, w: int, h: int, ndev: int):
    """Invert the tiled round-robin slot layout (`_round_robin_layout`
    with wh=(w, h)) with reshapes and transposes, no (3, r) scatter:
    slot (d, j, within) holds base tile j * ndev + d, and the tile-order
    base inverts as pipeline._untile does. Returns a flat (3, r) buffer
    in pixel order (the padded slots drop off the tail)."""
    k = max(1, -(-r // (ndev * TILE_PX)))
    n_tiles = ndev * k
    rp = _pad_to(r, n_tiles)
    tile = rp // n_tiles
    base = (accum3.reshape(3, ndev, k, tile).permute(0, 2, 1, 3)
            .reshape(3, rp)[:, :r])
    tw, th = tile_dims(w, h)
    t = base.reshape(3, h // th, w // tw, th, tw)
    return t.permute(0, 1, 3, 2, 4).reshape(3, h * w)


def assemble_frame(accum3, r: int, w: int, h: int, ndev: int):
    """The (3, H, W) frame from the slots in global order: the layout
    undone (`unpermute_slots`) and the reference's dead last row and
    column blacked out (scene.cpp:369-372). Shared by the ray-sharded and
    geometry-sharded primary passes. (JAX's `assemble_frame` also keeps
    a scatter through `perm` for layouts built without wh; every caller
    here builds with it.)"""
    frame3 = unpermute_slots(accum3, r, w, h, ndev).reshape(3, h, w)
    dev = frame3.device
    rows = torch.arange(h, device=dev)[:, None] < h - 1
    cols = torch.arange(w, device=dev)[None, :] < w - 1
    return torch.where(rows & cols, frame3, 0.0)


def _div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _primary_sharded(scene, mesh, *, ray_block, queue_headroom=1):
    st = scene.static
    w, h = st.settings.width, st.settings.height
    ndev = mesh.rays.size
    r = w * h
    _rp, perm = _round_robin_layout(r, ndev, (w, h), device=scene.device)
    perm = _local(perm, mesh.rays)
    # Padded slots (perm >= r) trace a duplicate ray, dropped below.
    xs = (perm % w).to(torch.float32)
    ys = torch.clamp_max(_div(perm, w), h - 1).to(torch.float32)
    accum3, stats = _integrate_slots_sharded(
        scene, mesh, xs, ys, ray_block=ray_block,
        queue_headroom=queue_headroom)
    if st.settings.show_normals:
        stats["rays_casted"] = float(r)
    return assemble_frame(accum3, r, w, h, ndev), stats


def _ssaa_sharded(scene, frame3, mesh, *, capacity, ray_block,
                  queue_headroom: int = 1):
    """Sobel-adaptive refinement (JAX `_ssaa_sharded`): the first
    pad_to(capacity, ndev) masked pixels of the replicated frame in
    raster order, split evenly over the ranks; each rank refines its
    pixels (`pipeline._ssaa_pass`'s three branches) into a (3, H*W)
    accumulator, and one SUM all-reduce assembles them (the refined
    pixels are disjoint across ranks). Returns (frame3, n_masked (host
    int), stats)."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    comm = mesh.rays
    cap = _pad_to(capacity, comm.size)
    mask = sobel_mask(frame3.detach())
    flat = mask.reshape(-1)
    n_masked = int(flat.sum())
    idx = torch.nonzero(flat).reshape(-1)[:cap].to(torch.int32)
    valid = torch.arange(cap, device=frame3.device) < idx.numel()
    idx_c = torch.nn.functional.pad(idx, (0, cap - idx.numel()),
                                    value=w * h - 1)
    idx_l, valid_l = _local(idx_c, comm), _local(valid, comm)
    nloc = idx_l.shape[0]
    ro, rd, pix, weight = ssaa_subsample_rays(scene, idx_l, valid_l, w)
    zeros = torch.zeros((3, w * h), device=frame3.device)
    if st.settings.show_normals:
        colors3 = shade_normals(scene, ro, rd, ray_block=ray_block)
        accum3 = index_accumulate(zeros, pix, weight[None, :] * colors3)
        stats = zero_stats()
    elif st.any_bouncing:
        accum3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block,
                                  queue_headroom=queue_headroom)
    else:
        # Subsample i of local pixel k sits at slot i * nloc + k; the four
        # sum as the single-device pass sums them; fill lanes add zeros.
        slots3, stats = integrate(scene, ro, rd, pix, weight, w * h,
                                  ray_block=ray_block, out_slots=True)
        s = slots3.reshape(3, 4, nloc)
        summed3 = ((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]
        accum3 = index_accumulate(zeros, idx_l, summed3)
    accum3 = collectives.sum_replicated(comm, accum3)
    stats = collectives.all_reduce_stats(comm, stats)
    frame3 = torch.where(mask[None], accum3.reshape(3, h, w), frame3)
    return frame3, n_masked, stats


def render_strip_sharded(scene, *, y0: int, rows: int, mesh,
                         ray_block: int = DEFAULT_RAY_BLOCK,
                         queue_headroom: int = 1):
    """The sharded strip (JAX `render_strip_sharded`): the primary rays
    of pixel rows [y0, y0 + rows) dealt over the ranks in the strip's own
    round-robin tile layout. `scene` has its gather tables derived.
    Returns (the strip's (3, rows * W) accumulator in pixel order, the
    counters summed over the ranks), the contract of the single-device
    `pipeline._render_strip`, so the strip loops take either."""
    st = scene.static
    w = st.settings.width
    ndev = mesh.rays.size
    r = rows * w
    _rp, perm = _round_robin_layout(r, ndev, (w, rows), device=scene.device)
    # Padded slots trace the strip's last pixel again, dropped below.
    pix = torch.clamp_max(_local(perm, mesh.rays), r - 1)
    xs = (pix % w).to(torch.float32)
    ys = (y0 + _div(pix, w)).to(torch.float32)
    accum3, stats = _integrate_slots_sharded(
        scene, mesh, xs, ys, ray_block=ray_block,
        queue_headroom=queue_headroom)
    if st.settings.show_normals:
        stats["rays_casted"] = float(r)
    return unpermute_slots(accum3, r, w, rows, ndev), stats


def ssaa_pass_sharded(scene, frame3, mesh, *, capacity: int,
                      ray_block: int = DEFAULT_RAY_BLOCK,
                      queue_headroom: int = 1):
    """The sharded SSAA refinement with `pipeline._ssaa_pass`'s contract
    (frame3, n_masked, stats); `scene` has its gather tables derived."""
    return _ssaa_sharded(scene, frame3, mesh, capacity=capacity,
                         ray_block=ray_block, queue_headroom=queue_headroom)


def _show_ac_sharded(scene, mesh, *, ray_block=DEFAULT_RAY_BLOCK):
    """The showAC heatmap with the pixels split in scanline blocks over
    the ranks: each rank runs the BVH walk (`count_ac_nodes`, the
    `ac_walk` kernel on a card) on its rays, one all-gather joins the
    counts, and every rank divides by the frame's largest."""
    st = scene.static
    w, h = st.settings.width, st.settings.height
    comm = mesh.rays
    r = w * h
    rp = _pad_to(r, comm.size)
    pix = _local(torch.arange(rp, dtype=torch.int32, device=scene.device),
                 comm)
    xs = (pix % w).to(torch.float32)
    ys = torch.clamp_max(_div(pix, w), h - 1).to(torch.float32)
    rd = pixel_dirs(scene, xs, ys, 0.5, 0.5)
    ro = scene.cam_pos.expand(rd.shape)
    parts = []
    for b in range(0, rd.shape[0], ray_block):
        ro_b = ro[b:b + ray_block].contiguous()
        rd_b = rd[b:b + ray_block].contiguous()
        counts = torch.zeros((ro_b.shape[0],), dtype=torch.int32,
                             device=ro.device)
        for m in scene.meshes:
            counts = counts + count_ac_nodes(m, ro_b, rd_b,
                                             use_ac=st.settings.use_ac)
        parts.append(counts)
    counts = collectives.all_gather(comm, torch.cat(parts))[:r]
    ac_max = torch.clamp_min(counts.max(), 1)
    val = counts.to(torch.float32) / ac_max.to(torch.float32)
    return val[None, :].expand(3, r).reshape(3, h, w)


def render_scene_sharded(scene, mesh, ray_block: int = DEFAULT_RAY_BLOCK,
                         ssaa_capacity: int | None = None,
                         queue_headroom: int = 1, out_u8: bool = False):
    """The sharded render over `mesh`'s ray axis: (frame3 (3, H, W), aux)
    on every rank, equal up to f32 summation order to
    `pipeline.render_scene` (bit-equal where nothing bounces: each ray's
    work is the same), and differentiable. `ssaa_capacity` overrides the
    fraction-derived refinement queue and `queue_headroom` multiplies
    each rank's transparent queue (`render_sharded` escalates both: a
    rank holding more than its share of glass pixels can need headroom
    the single-device render does not)."""
    from rendering_tpu_torch.render.pipeline import (
        default_ssaa_capacity,
        derive_mesh_tables,
        quantize_u8,
    )

    settings = scene.static.settings
    if settings.show_ac:
        frame3 = _show_ac_sharded(scene, mesh, ray_block=ray_block)
        return (quantize_u8(frame3) if out_u8 else frame3), {
            "stats": zero_stats(), "ssaa_masked": 0}
    scene = derive_mesh_tables(scene)
    frame3, stats = _primary_sharded(scene, mesh, ray_block=ray_block,
                                     queue_headroom=queue_headroom)
    n_masked = 0
    if settings.enable_ssaa:
        frame3, n_masked, s2 = _ssaa_sharded(
            scene, frame3, mesh,
            capacity=ssaa_capacity or default_ssaa_capacity(settings),
            ray_block=ray_block, queue_headroom=queue_headroom)
        stats = {k: stats[k] + s2[k] for k in stats}
    aux = {"stats": stats, "ssaa_masked": n_masked}
    return (quantize_u8(frame3) if out_u8 else frame3), aux


def render_sharded(scene, mesh=None, ray_block: int = DEFAULT_RAY_BLOCK,
                   out_u8: bool = False):
    """Host-facing sharded render: ((H, W, 3) numpy frame, aux) on every
    rank, u8 codes with out_u8, else f32. Like `pipeline.render`, both
    queue sizes escalate so the output matches the single-device render:
    the SSAA capacity on a mask overflow (judged against the capacity
    padded to the rank count) and each rank's transparent-queue
    headroom on dropped paths. Every rank reaches the same decision: the
    mask comes from the replicated frame and the drops are summed."""
    from rendering_tpu_torch.render.pipeline import escalating_render

    mesh = mesh or make_ray_mesh()
    with torch.no_grad():
        frame, aux = escalating_render(
            lambda cap, headroom: render_scene_sharded(
                scene, mesh, ray_block=ray_block, ssaa_capacity=cap,
                queue_headroom=headroom, out_u8=out_u8),
            scene.static.settings, cap_pad=mesh.rays.size)
    if not out_u8:
        frame = frame.permute(1, 2, 0)
    return frame.cpu().numpy(), aux
