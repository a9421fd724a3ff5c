"""Multi-frame rendering: animations and batch serving — the port of
`rendering_tpu.render.animation`.

The reference renders one frame per process (src/main.cpp:5-16). Here the
camera is two tensors of SceneData (`cam_pos` (3,), `cam_rmat` (3, 3)), so
moving it between frames swaps two small tensors and rebuilds nothing:
the scene's tables, meshes and maps stay on the device for every frame.

Euler conventions match the reference camera (src/scene.cpp:16-54):
rotation matrix mz*my*mx in degrees, applied to row vectors (v @ R),
forward = (0, 0, -1) @ R. `look_at_rotation` and `orbit_cameras` are the
JAX package's float64 numpy code as it is.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from rendering_tpu_torch.models.objloader import euler_matrix
from rendering_tpu_torch.render.integrator import DEFAULT_RAY_BLOCK
from rendering_tpu_torch.render.pipeline import (
    default_ssaa_capacity,
    render,
    render_scene,
)
from rendering_tpu_torch.utils.tracing import span


def look_at_rotation(pos, target) -> np.ndarray:
    """Euler angles (degrees, roll-free) that aim the reference camera
    at `target` from `pos`: forward (0,0,-1) @ euler_matrix(result)
    equals normalize(target - pos), with the camera kept upright
    (up_y >= 0) wherever that is possible without roll.

    Derivation under the mz*my*mx row-vector convention with rz=0:
    forward = (sin ry, -cos ry * sin rx, -cos ry * cos rx).
    """
    d = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    n = np.linalg.norm(d)
    if n == 0:
        raise ValueError("look_at target coincides with camera position")
    dx, dy, dz = d / n
    h = math.hypot(dy, dz)  # |cos ry|
    if h == 0.0:
        # Looking straight along +-x: pitch is degenerate (gimbal);
        # pick rx = 0.
        return np.array([0.0, math.copysign(90.0, dx), 0.0], np.float64)
    cy = -h if dz > 0 else h  # upright choice: up_y = cos rx >= 0
    rx = math.degrees(math.atan2(-dy / cy, -dz / cy))
    ry = math.degrees(math.atan2(dx, cy))
    return np.array([rx, ry, 0.0], np.float64)


def set_camera(scene, pos, rot_deg=None, *, look_at=None):
    """A new SceneData with the camera moved: `cam_pos` and the
    `euler_matrix` of the angles, on the scene's device. Exactly one of
    `rot_deg` (Euler degrees, reference convention) or `look_at`
    (world-space target point) must be given."""
    if (rot_deg is None) == (look_at is None):
        raise ValueError("pass exactly one of rot_deg / look_at")
    if look_at is not None:
        rot_deg = look_at_rotation(pos, look_at)
    dev = scene.device
    with span("rt.sync.camera"):
        return dataclasses.replace(
            scene,
            cam_pos=torch.tensor(np.asarray(pos, np.float32), device=dev),
            cam_rmat=torch.from_numpy(euler_matrix(rot_deg)).to(dev),
        )


def orbit_cameras(center, radius: float, n_frames: int, *,
                  elevation_deg: float = 0.0, start_deg: float = 0.0):
    """Turntable path: `n_frames` (pos, rot_deg) pairs on a circle of
    `radius` around `center` at `elevation_deg` above its horizon, each
    aimed at `center`. Feed to `render_frames`."""
    center = np.asarray(center, np.float64)
    el = math.radians(elevation_deg)
    out = []
    for k in range(n_frames):
        th = math.radians(start_deg + 360.0 * k / n_frames)
        pos = center + radius * np.array(
            [math.sin(th) * math.cos(el), math.sin(el),
             math.cos(th) * math.cos(el)]
        )
        out.append((pos, look_at_rotation(pos, center)))
    return out


def _render_one(s, mesh, ray_block, out_u8):
    """`render`, or `parallel.shard.render_sharded` over `mesh`."""
    if mesh is None:
        return render(s, ray_block=ray_block, out_u8=out_u8)
    from rendering_tpu_torch.parallel.shard import render_sharded

    return render_sharded(s, mesh, ray_block=ray_block, out_u8=out_u8)


def render_frames(scene, cameras, *, mesh=None,
                  ray_block: int = DEFAULT_RAY_BLOCK, out_u8: bool = False):
    """One frame per (pos, rot_deg) camera, each `render`'s ((H, W, 3)
    numpy frame, aux), yielded lazily so that a caller can stream frames
    to disk or an encoder without holding the animation. With `mesh`
    each frame renders sharded over the ray mesh (`render_sharded`, the
    same frame on every rank). With `out_u8` frames are the BMP writer's
    u8 codes, quantized on the device (4x smaller pull). Each frame keeps
    the redo of an SSAA overflow or of dropped transparent paths."""
    return (_render_one(set_camera(scene, pos, rot_deg=rot), mesh, ray_block,
                        out_u8) for pos, rot in cameras)


def render_frames_pipelined(scene, cameras, *, mesh=None,
                            ray_block: int = DEFAULT_RAY_BLOCK,
                            out_u8: bool = False, depth: int = 2):
    """render_frames with up to `depth` frames in flight: frame k + 1's
    render is queued before frame k is handed over, and each frame's pull
    is a non-blocking copy into pinned host memory (with the counters the
    redo test reads) behind a CUDA event that `finish` waits for, so the
    card computes the next frame while the host takes the previous one.
    Same outputs as render_frames: a frame whose SSAA mask outgrew the
    queue (`default_ssaa_capacity`, padded to the rank count under a
    mesh, as the sharded pass pads it) or whose transparent queue
    dropped paths is redone through the escalating wrapper. The SSAA
    pass reads its mask size on the host while it is queued
    (`torch.nonzero`), so on an SSAA scene queuing frame k + 1 waits for
    its primary pass; so do a mesh's collectives. depth <= 1 renders one
    frame at a time."""
    return _pipelined(scene, cameras, mesh=mesh, ray_block=ray_block,
                      out_u8=out_u8, depth=depth)


def _pipelined(scene, cameras, *, mesh, ray_block, out_u8, depth):
    st = scene.static.settings
    cap = default_ssaa_capacity(st)
    cuda = scene.device.type == "cuda"
    if mesh is None:
        render_fn = render_scene
    else:
        from rendering_tpu_torch.parallel.shard import (
            _pad_to,
            render_scene_sharded,
        )

        cap = _pad_to(cap, mesh.rays.size)

        def render_fn(s, **kw):
            return render_scene_sharded(s, mesh, **kw)

    def dispatch(s):
        with span("rt.render"), torch.no_grad():
            frame, aux = render_fn(s, ray_block=ray_block, out_u8=out_u8)
        if not out_u8:
            frame = frame.permute(1, 2, 0)
        dropped = aux["stats"]["paths_dropped"]
        if not cuda:
            return s, frame.contiguous(), dropped, None, aux
        host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
        host.copy_(frame, non_blocking=True)
        dropped_host = torch.empty((), pin_memory=True)
        dropped_host.copy_(dropped, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return s, host, dropped_host, done, aux

    def finish(s, host, dropped, done, aux):
        if done is not None:
            with span("rt.sync.frame"):
                done.synchronize()
        overflow = (st.enable_ssaa and not st.show_ac
                    and aux["ssaa_masked"] > cap)
        if overflow or float(dropped) > 0:
            # Redo through the escalating wrapper (this frame only).
            return _render_one(s, mesh, ray_block, out_u8)
        return host.numpy(), aux

    pending = deque()
    for pos, rot in cameras:
        # Drain before queuing, so at most `depth` frames are in flight.
        if pending and len(pending) >= depth:
            yield finish(*pending.popleft())
        pending.append(dispatch(set_camera(scene, pos, rot_deg=rot)))
    while pending:
        yield finish(*pending.popleft())
