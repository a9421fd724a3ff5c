"""The gradient all-reduce of the sharded train step in two schedules —
the port of `rendering_tpu.parallel.overlap`.

Each rank's backward leaves its share of every parameter's gradient
(`parallel.collectives`: the slot all-gather hands each rank its slice of
the cotangent); one SUM over the ray ranks gives the gradient of the
loss. The JAX package had both schedules from shard_map's AD: per-bounce
psums inside the backward scan, or one bulk psum after it. Here:

* overlap=True: the parameters are cut into buckets of at most
  BUCKET_BYTES (in reverse order: the last parameters' gradients tend to
  be final first), and each bucket's flattened gradients go out in one
  asynchronous all-reduce as soon as the last of them is final during
  backward (`register_post_accumulate_grad_hook`). Buckets launch in
  bucket order on every rank, whatever order their hooks fire in, so the
  ranks issue the same collectives in the same order. The step waits on
  all of them before it returns.
* overlap=False: one all-reduce of all the flattened gradients after
  backward.

Both give the same gradients up to f32 reduction order, and every rank
receives the same bits, so an optimizer step keeps the ranks' parameters
equal. Each bucket's launch, and the wait for them all, is the span
`rt.ranks.all_reduce` in a recorded trace.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rendering_tpu_torch.parallel.collectives import Comm
from rendering_tpu_torch.utils.tracing import span

# Gradient bytes per asynchronous all-reduce of the overlapped schedule.
BUCKET_BYTES = 16 << 20


class GradReducer:
    """Context manager around a rank's backward: on exit every
    parameter's .grad holds the SUM of the ranks' gradients over `comm`,
    in either schedule. Parameters with no gradient on every rank stay
    without one."""

    def __init__(self, params, comm: Comm, *, overlap: bool = True):
        self.params = list(params)
        self.comm = comm
        self.overlap = overlap
        self.buckets = []
        size = None
        for p in reversed(self.params):
            nbytes = p.numel() * p.element_size()
            if size is None or size + nbytes > BUCKET_BYTES:
                self.buckets.append([])
                size = 0
            self.buckets[-1].append(p)
            size += nbytes
        self.pending = [len(b) for b in self.buckets]
        self.launched = 0
        self.works = []
        self.hooks = []

    def __enter__(self):
        if self.overlap and self.comm.size > 1:
            for bi, bucket in enumerate(self.buckets):
                for p in bucket:
                    self.hooks.append(p.register_post_accumulate_grad_hook(
                        lambda _p, bi=bi: self._ready(bi)))
        return self

    def _ready(self, bi: int):
        self.pending[bi] -= 1
        while (self.launched < len(self.buckets)
               and self.pending[self.launched] == 0):
            self._launch(self.buckets[self.launched])
            self.launched += 1

    def _launch(self, bucket):
        """Start the SUM all-reduce of a bucket's flattened gradients
        (a parameter without one sends zeros)."""
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in bucket])
        with span("rt.ranks.all_reduce"):
            work = dist.all_reduce(flat, group=self.comm.group,
                                   async_op=True)
        self.works.append((bucket, flat, work))

    def __exit__(self, exc_type, exc, tb):
        for h in self.hooks:
            h.remove()
        if exc_type is not None or self.comm.size == 1:
            return False
        if self.overlap:
            while self.launched < len(self.buckets):
                self._launch(self.buckets[self.launched])
                self.launched += 1
        else:
            self._launch(self.params)
        had = {id(p) for p in self.params if p.grad is not None}
        for bucket, flat, work in self.works:
            with span("rt.ranks.all_reduce"):
                work.wait()
            o = 0
            for p in bucket:
                n = p.numel()
                if id(p) in had:
                    p.grad.copy_(flat[o:o + n].view_as(p))
                o += n
        return False


def make_sharded_grad_fn(paths, mesh, *, overlap: bool = True,
                         ray_block: int | None = None):
    """The primary-pass sharded loss and gradient with a chosen
    all-reduce schedule (JAX `make_sharded_grad_fn`).

    Returns f(params, scene, target3) -> (loss, grads): params is
    `diff.inverse.extract_params`'s dict of leaf tensors, target3 a
    (3, H, W) frame on the mesh's device; loss (0-d, detached) is the
    mean squared error over the rendered pixels (the reference's dead
    last row and column left out), grads the parameters' .grad tensors,
    summed over the ranks. Scope, as JAX's: the primary pass, no SSAA
    (render with enable_ssaa=False). Runs under
    `deterministic_algorithms()`. As `diff.inverse.make_train_step`, the
    integration runs inside `growing_queue`, and on a transparent scene a
    forward that dropped paths on any rank raises before the backward
    (`diff.inverse.check_dropped`)."""
    from rendering_tpu_torch.device import deterministic_algorithms
    from rendering_tpu_torch.diff.inverse import apply_params, check_dropped
    from rendering_tpu_torch.parallel import collectives
    from rendering_tpu_torch.parallel.shard import _local, _round_robin_layout
    from rendering_tpu_torch.render.integrator import (
        DEFAULT_RAY_BLOCK,
        QueueGrowth,
        growing_queue,
        integrate,
    )
    from rendering_tpu_torch.render.pipeline import derive_mesh_tables
    from rendering_tpu_torch.render.raygen import pixel_dirs

    paths = tuple(tuple(p) for p in paths)
    ray_block = ray_block or DEFAULT_RAY_BLOCK
    comm = mesh.rays
    growth = QueueGrowth()

    def grad_fn(params, scene, target3):
        st = scene.static
        w, h = st.settings.width, st.settings.height
        if st.settings.enable_ssaa:
            raise ValueError("make_sharded_grad_fn covers the primary pass "
                             "only; render with enable_ssaa=False")
        r = w * h
        dev = scene.device
        _rp, perm = _round_robin_layout(r, comm.size, (w, h), device=dev)
        perm = _local(perm, comm).long()
        xs = (perm % w).to(torch.float32)
        ys = torch.clamp_max(perm // w, h - 1).to(torch.float32)
        # Padded slots and the dead last row and column (scene.cpp:369-372)
        # weigh 0 in the loss.
        px = torch.clamp_max(perm, r - 1)
        valid = ((perm < r) & (px % w != w - 1)
                 & (px // w != h - 1)).to(torch.float32)
        tgt = target3.reshape(3, r)[:, px]
        n_loss_px = (w - 1) * (h - 1)
        nloc = xs.shape[0]
        for p in params.values():
            p.grad = None
        with deterministic_algorithms():
            s = derive_mesh_tables(apply_params(scene, params, paths))
            rd = pixel_dirs(s, xs, ys, 1.0, 1.0)
            ro = s.cam_pos.expand(rd.shape)
            with growing_queue(growth):
                slots3, _stats = integrate(
                    s, ro, rd,
                    torch.arange(nloc, dtype=torch.int32, device=dev),
                    torch.ones((nloc,), device=dev), nloc,
                    ray_block=ray_block, out_slots=not st.any_bouncing)
            if st.any_transparent:
                check_dropped(growth, comm)
            err = (slots3 - tgt) * valid[None, :]
            loss_r = torch.sum(err * err) / (3.0 * n_loss_px)
            with GradReducer(params.values(), comm, overlap=overlap):
                loss_r.backward()
        loss = collectives.all_reduce(comm, loss_r.detach())
        return loss, {k: p.grad for k, p in params.items()}

    return grad_fn
