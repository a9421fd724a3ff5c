"""Traffic kind `train_sharded`: the `train` kind's steps with the rays
sharded over `ranks` ranks, one card each, and the gradients summed over
them (`diff.inverse.make_train_step(mesh=)`: `parallel.shard`'s render,
`parallel.overlap`'s all-reduce).

Rank 0 is the harness's process; `setup` starts ranks 1 to ranks - 1
itself, each as `python3 benchmark/traffic/train_sharded.py <spec>
<rank>` on card `cuda:<rank>` (or the CPU, where every rank joins over
gloo), and every rank joins the process group through the port's
`parallel.multihost`, which picks the backend: NCCL with a card a rank.
With fewer cards than ranks the kind refuses: nothing stands in for an
absent card.

Every rank builds the same scenes from the seed (`train`'s true and
start scenes), renders the target with the sharded render and runs the
same steps in lockstep: set-up's `check_steps`, which rank 0 records for
the comparison as `train` does, then one step a request, each started
by a flag that rank 0 broadcasts (1: step, 0: stop). `release` stops
and joins the other ranks. The result's device counts every rank's
card: at set-up the ranks gather their cards' UUIDs (two ranks on one
card refuse), and `finish` wraps the runner's `_describe_device`, which
counts one device, for its one next call, which it makes right after
`finish`; `release` takes the wrapper off if it was not called. Its
kind and peak memory stay rank 0's card's. The reference is `train`'s:
the unsharded steps of the same scenes. A request's rays are the whole
frame's, W x H, so the rate compares with the one-card cell's.

Workload parameters: `train`'s, plus ranks and overlap (the gradient
all-reduce overlapped with the backward, the schedule of
`make_train_step(mesh=)`; only true is run).

Faults: `state_unchanged` and `half_batch_sharded`, the sharded render's
half batch (half of the frame's rows left out on rank 0, the pixel loss
the mean over the rest), registered in `harness/faults.py`'s tables when
this module loads.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import types

if __name__ == "__main__":
    _BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TRITON_CACHE_DIR"] = os.path.join(
        os.path.dirname(_BENCH), "build", "triton_cache")
    sys.path[:0] = [os.path.dirname(_BENCH), _BENCH]

import torch  # noqa: E402

from harness import faults, registry, runner  # noqa: E402

base = registry.traffic("train")

# Seconds the other ranks get to leave after the stop flag.
JOIN_S = 120


def half_batch_sharded():
    """`faults.half_batch` on the sharded render: half of the frame's
    rows left out, the pixel loss the mean over the rest."""
    import rendering_tpu_torch.parallel.shard as shard

    orig = shard.render_scene_sharded

    def half(scene, mesh, *a, **kw):
        frame, aux = orig(scene, mesh, *a, **kw)
        return frame[:, :frame.shape[1] // 2], aux

    return faults._patched(shard, "render_scene_sharded", half)


faults.FAULTS.setdefault("half_batch_sharded", half_batch_sharded)
faults.KIND_FAULTS.setdefault("train_sharded",
                              ("state_unchanged", "half_batch_sharded"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_state(ctx, rank: int, ranks: int, port: int) -> dict:
    """Join the group as `rank`, build the scenes, render the target and
    run the check steps; rank 0 keeps what the comparison reads."""
    from rendering_tpu_torch.diff.inverse import (
        extract_params,
        make_train_step,
    )
    from rendering_tpu_torch.parallel import multihost, shard

    dev = ("cpu" if ctx.device.type == "cpu"
           else torch.device("cuda", rank))
    multihost.initialize_distributed(f"localhost:{port}", ranks, rank,
                                     device=dev)
    mesh = multihost.make_global_ray_mesh(device=dev)
    cards = _gather_cards(torch.device(dev), ranks)
    p = ctx.cell["params"]
    desc = base._true_desc(ctx)
    start = base._start_desc(desc, p, ctx.seed)
    with torch.no_grad():
        target = shard.render_scene_sharded(
            base.scenes.program_scene(desc, mesh.device), mesh)[0]
    scene = base.scenes.program_scene(start, mesh.device)
    paths = tuple(tuple(x) for x in p["paths"])
    keys = [base._key(x) for x in paths]
    lrs = [float(p["lr"][k]) for k in keys]

    def optimizer(ps):
        return torch.optim.Adam([{"params": [t], "lr": lr}
                                 for t, lr in zip(ps, lrs)],
                                betas=(base.BETA1, 0.999), eps=1e-8)

    init_fn, step_fn = make_train_step(paths, optimizer=optimizer, mesh=mesh)
    params = extract_params(scene, paths)
    opt = init_fn(params)
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, grad_norms = [], {}
    for i in range(int(p["check_steps"])):
        params, opt, loss = step_fn(params, opt, scene, target)
        losses.append(float(loss))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(
                opt.state[v]["exp_avg"] / (1 - base.BETA1)))
                for k, v in params.items()}
    delta = {k: float(torch.linalg.vector_norm(v.detach() - p0[k]))
             for k, v in params.items()}
    st = desc["settings"]
    return {"desc": desc, "start": start, "keys": keys,
            "lrs": dict(zip(keys, lrs)), "params": params, "opt": opt,
            "scene": scene, "target": target, "step_fn": step_fn,
            "mesh": mesh, "flag": torch.zeros((1,), dtype=torch.int64,
                                              device=_flag_device(mesh)),
            "losses": [], "rays": int(st["width"]) * int(st["height"]),
            "prog": {"losses": losses, "grad_norms": grad_norms,
                     "delta_norms": delta},
            "check_steps": int(p["check_steps"]), "device": ctx.device,
            "cards": cards}


def _gather_cards(dev, ranks: int) -> int:
    """The devices the group's ranks run on, one each: on CUDA every
    rank's card UUID, gathered, and a card that two ranks share
    refuses; on the CPU every rank is a process of its own."""
    import torch.distributed as dist

    if dev.type != "cuda":
        return ranks
    uuids = [None] * ranks
    dist.all_gather_object(uuids,
                           str(torch.cuda.get_device_properties(dev).uuid))
    if len(set(uuids)) < ranks:
        raise RuntimeError(f"{ranks} ranks on {len(set(uuids))} card(s): "
                           f"the cell needs a card a rank")
    return ranks


def _count_cards(state):
    """Wrap the runner's `_describe_device` for its next call: the same
    description of rank 0's card, with `count` every rank's card."""
    describe = runner._describe_device

    def counting(device):
        runner._describe_device = describe
        info = describe(device)
        info["count"] = state["cards"]
        return info

    state["describe"] = describe
    runner._describe_device = counting


def _uncount_cards(state):
    describe = state.pop("describe", None)
    if describe is not None:
        runner._describe_device = describe


def _flag_device(mesh):
    """The flag's device: the rank's card under NCCL, else the CPU."""
    import torch.distributed as dist

    return (mesh.device if dist.get_backend() == "nccl"
            else torch.device("cpu"))


def _flag(state, value=None) -> int:
    """Broadcast rank 0's flag (value) to every rank; returns it."""
    import torch.distributed as dist

    f = state["flag"]
    if value is not None:
        f.fill_(value)
    dist.broadcast(f, src=0)
    return int(f.item()) if value is None else value


def _step(state):
    state["params"], state["opt"], loss = state["step_fn"](
        state["params"], state["opt"], state["scene"], state["target"])
    return loss


def setup(ctx):
    p = ctx.cell["params"]
    ranks = int(p["ranks"])
    if not p.get("overlap", True):
        raise ValueError("make_train_step(mesh=) overlaps its all-reduce; "
                         "overlap false is not run")
    if ctx.device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"the cell needs {ranks} cards, one a rank; "
                           f"{torch.cuda.device_count()} visible")
    port = _free_port()
    spec = os.path.join(ctx.workdir, "ranks.json")
    with open(spec, "w") as fh:
        json.dump({"name": ctx.name, "seed": ctx.seed,
                   "device": ctx.device.type, "overrides": ctx.overrides,
                   "port": port, "ranks": ranks}, fh)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               spec, str(r)], stdout=subprocess.DEVNULL)
             for r in range(1, ranks)]
    try:
        state = _rank_state(ctx, 0, ranks, port)
    except BaseException:
        for pr in procs:
            pr.kill()
        raise
    state["procs"] = procs
    return state


def request(state):
    _flag(state, 1)
    state["losses"].append(_step(state))
    return {}


def finish(state, records):
    for rec, loss in zip(records, state["losses"]):
        if not bool(torch.isfinite(loss)):
            rec["ok"] = False
    _count_cards(state)


def end_to_end(state, records, window_s):
    return base.end_to_end(state, records, window_s)


def release(state):
    import torch.distributed as dist

    _uncount_cards(state)
    if "flag" in state:
        _flag(state, 0)
    deadline = time.monotonic() + JOIN_S
    for pr in state.pop("procs", []):
        try:
            pr.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pr.kill()
    if dist.is_initialized():
        dist.destroy_process_group()
    for k in ("params", "opt", "scene", "target", "step_fn", "losses",
              "mesh", "flag"):
        state.pop(k, None)


def check(state, records, dtype):
    return base.check(state, records, dtype)


def control(state, records, dtype):
    return base.control(state, records, dtype)


def _helper(spec_path: str, rank: int) -> int:
    """Rank `rank` of a cell: the same set-up, then a step for each
    flag of 1 until a 0."""
    import torch.distributed as dist

    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    cell = registry.workload(spec["name"])
    ctx = types.SimpleNamespace(name=spec["name"], cell=cell,
                                cfg=registry.config(cell["config"]),
                                seed=spec["seed"],
                                device=torch.device(spec["device"]),
                                overrides=spec["overrides"])
    state = _rank_state(ctx, rank, spec["ranks"], spec["port"])
    while _flag(state):
        _step(state)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_helper(sys.argv[1], int(sys.argv[2])))
