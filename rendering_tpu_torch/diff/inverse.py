"""Inverse rendering — gradient descent on scene parameters, the port of
`rendering_tpu.diff.inverse` on torch autograd.

render -> pixel loss against a target image -> `backward` through the
integrator -> optimizer step, on any float tensor of the SceneData:
light intensities and colours, object colours and materials, sphere
and plane geometry, mesh vertices, normals, uvs and maps.

Parameters are addressed by paths into the SceneData, e.g.

    ("lights", 0, "intensity")
    ("obj_color",)
    ("meshes", 0, "v")

and held in a dict keyed by the path joined with "/" ("lights/0/
intensity"), as in the JAX package. Each parameter is a leaf tensor that
requires grad; `apply_params` returns a new SceneData around them and
writes nothing in place. The optimizer steps the leaves in place, as
torch's optimizers do, where optax returns new arrays: no copy of the
parameters is made per step.

On a scene with transparent objects the step's continuation queue
drops no path: the forward runs inside `render.integrator.
growing_queue` with capacities the step keeps from step to step, and a
step whose children outgrow the queue's limit raises `QueueOverflow`
before its backward, so no gradient of a truncated path tree is
returned.

The kernel chunk tables stay as built. A vertex step changes `v`, and
the gather table that the differentiable hit re-evaluation reads is
derived from it in every render, but the oracle keeps picking triangles
from the build-time tables, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from rendering_tpu_torch.device import deterministic_algorithms
from rendering_tpu_torch.render.integrator import (
    MAX_QUEUE_HEADROOM,
    QueueGrowth,
    QueueOverflow,
    growing_queue,
)
from rendering_tpu_torch.render.pipeline import render_scene
from rendering_tpu_torch.utils.tracing import span

Path = tuple


def _key(path: Path) -> str:
    return "/".join(map(str, path))


def _get(node, path: Path):
    for p in path:
        node = node[p] if isinstance(p, int) else getattr(node, p)
    return node


def _set(node, path: Path, value):
    """A copy of `node` with the tensor at `path` replaced by `value`
    (tuples and dataclasses rebuilt along the path, nothing written)."""
    p = path[0]
    child = value if len(path) == 1 else _set(
        node[p] if isinstance(p, int) else getattr(node, p), path[1:], value)
    if isinstance(p, int):
        return node[:p] + (child,) + node[p + 1:]
    return dataclasses.replace(node, **{p: child})


def extract_params(scene, paths: Sequence[Path]) -> dict:
    """{"/"-joined path: leaf tensor}: a copy of each addressed tensor,
    detached from the scene, that requires grad."""
    return {_key(p): _get(scene, p).detach().clone().requires_grad_(True)
            for p in paths}


def apply_params(scene, params: dict, paths: Sequence[Path]):
    """A new SceneData holding params[key] at each path."""
    for p in paths:
        scene = _set(scene, tuple(p), params[_key(p)])
    return scene


def adam(params: list) -> torch.optim.Optimizer:
    """The default optimizer: Adam at lr 1e-2, eps 1e-8 (optax.adam(1e-2),
    the JAX package's default, has the same update formula)."""
    return torch.optim.Adam(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


def check_dropped(growth: QueueGrowth, comm=None) -> None:
    """Raise `QueueOverflow` when the forward inside
    `growing_queue(growth)` dropped paths on this rank or, with `comm`
    (a ray axis), on any rank of it (one all-reduce, so every rank
    raises alike)."""
    dropped = growth.dropped
    if comm is not None and comm.size > 1:
        from rendering_tpu_torch.parallel import collectives

        with span("rt.sync.dropped"):
            dropped = int(collectives.all_reduce(
                comm, torch.tensor([dropped], dtype=torch.int64,
                                   device=collectives.backend_device(comm))
            ).item())
    if dropped:
        raise QueueOverflow(
            f"{dropped} transparent continuation paths outgrew the queue's "
            f"limit ({MAX_QUEUE_HEADROOM} x the pass's rays); a step on "
            f"the truncated path tree would give a wrong gradient")


def make_train_step(paths: Sequence[Path],
                    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
                    mesh=None, render_fn=None):
    """Build (init_fn, step_fn):

        opt_state = init_fn(params)
        params, opt_state, loss = step_fn(params, opt_state, scene, target)

    `optimizer` builds the torch optimizer over the list of parameter
    tensors (default `adam`); opt_state is that optimizer. The loss is
    the mean squared pixel difference between the (3, H, W) frame of
    `render_fn(scene)` (default: `render_scene`'s frame) and `target`.
    With `mesh` (a ray mesh, `parallel.shard.make_ray_mesh`) the default
    frame is `render_scene_sharded`'s, every rank computes the same loss,
    its backward leaves its share of each gradient, and the shares are
    summed over the ranks during backward
    (`parallel.overlap.GradReducer`) before the optimizer steps on every
    rank: the parameters stay equal bit for bit across the ranks.
    step_fn returns the same parameter tensors, stepped in place, and
    the loss of the step, detached. The step runs under
    `deterministic_algorithms`, so two steps from the same state are
    bit-equal on the card too. In a recorded trace the step is the span
    `rt.train.step` holding `rt.train.forward` (render and loss),
    `rt.train.backward` and `rt.train.optimizer`.

    The forward renders inside `growing_queue` with one `QueueGrowth`
    per step_fn: a transparent scene's continuation queue keeps every
    live child (its capacities settle in the first step), and a forward
    that dropped paths at the queue's limit raises before the backward
    (`check_dropped`: no host read on one device, one all-reduce with
    `mesh` on a transparent scene)."""
    paths = tuple(tuple(p) for p in paths)
    optimizer = optimizer or adam
    if render_fn is None:
        if mesh is not None:
            from rendering_tpu_torch.parallel.shard import (
                render_scene_sharded,
            )

            def render_fn(s):
                return render_scene_sharded(s, mesh)[0]
        else:
            def render_fn(s):
                return render_scene(s)[0]

    def backward(loss, params):
        if mesh is None:
            loss.backward()
            return
        from rendering_tpu_torch.parallel.overlap import GradReducer

        with GradReducer(params.values(), mesh.rays):
            loss.backward()

    growth = QueueGrowth()

    def init_fn(params: dict):
        return optimizer(list(params.values()))

    def step_fn(params: dict, opt_state, scene, target):
        with span("rt.train.step"), deterministic_algorithms():
            opt_state.zero_grad(set_to_none=True)
            with span("rt.train.forward"), growing_queue(growth):
                frame = render_fn(apply_params(scene, params, paths))
                loss = torch.mean((frame - target) ** 2)
            if scene.static.any_transparent:
                check_dropped(growth, mesh.rays if mesh is not None else None)
            with span("rt.train.backward"):
                backward(loss, params)
            with span("rt.train.optimizer"):
                opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn
