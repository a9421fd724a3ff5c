"""Process-group init and the node-level helpers of the multi-device
layer — the port of `rendering_tpu.parallel.multihost` on
torch.distributed.

One process per rank, each on one device: `cuda:{LOCAL_RANK}` (modulo
the visible cards), or the CPU when the caller asks for it. The launcher
(`torchrun --nproc-per-node=N -m rendering_tpu_torch scene.scene`, or the
CLI's own spawn) sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK; `initialize_distributed` reads them, explicit arguments win,
and a partial set raises, as the JAX package's does.

The backend is chosen, and printed, from the ranks and cards: NCCL when
every rank of the node has a card of its own, gloo on the CPU, and gloo
over CUDA tensors when ranks share a card (NCCL refuses two ranks on one
device; gloo copies the tensors through host memory itself). Every group is made with a finite timeout, so
a rank whose collectives diverge fails instead of hanging.

Import order does not matter here (the JAX package had to initialize
before any backend use): nothing at import time touches a device.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from rendering_tpu_torch.device import resolve_device

# A collective that waits longer than this raises on every rank.
TIMEOUT = datetime.timedelta(seconds=60)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_world_size() -> int:
    """The ranks on this node (torchrun's LOCAL_WORLD_SIZE; else every
    rank, one node)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for; else its card,
    cuda:{LOCAL_RANK modulo the visible cards} (raises without a card,
    as every entry point does)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device: torch.device, n_local: int) -> tuple[str, str]:
    """(backend, why) for n_local ranks on this node on `device`'s
    kind."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if cards >= n_local:
        return "nccl", f"{n_local} ranks on {cards} cards, a card each"
    return "gloo", (f"{n_local} ranks share {cards} card(s); gloo over "
                    f"CUDA tensors")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> bool:
    """Join the process group. Returns True when this process is one of
    several ranks (now or already joined), False for the one-process
    case (nothing configured). `coordinator_address` is "host:port" or
    an init_method URL ("tcp://...", "file://..."); the environment's
    MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK fill what the arguments
    leave out, and a partial set raises. `device` is the caller's (None:
    the card); the backend follows `choose_backend`, printed."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None or coordinator_address.endswith(":"):
        raise ValueError(
            "distributed init needs coordinator_address, num_processes AND "
            "process_id (arguments or MASTER_ADDR/MASTER_PORT, WORLD_SIZE, "
            f"RANK); got address={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}")
    dev = rank_device(device)
    n_local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend, why = choose_backend(dev, n_local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    print(f"rank {process_id} of {num_processes}: torch.distributed backend "
          f"{backend} on {dev} ({why})")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return num_processes > 1


def make_global_ray_mesh(device=None):
    """The 1-D ray mesh over every rank (`shard.make_ray_mesh`)."""
    from rendering_tpu_torch.parallel.shard import make_ray_mesh

    return make_ray_mesh(device=device)


def make_host_ray_mesh(device=None):
    """The 1-D ray mesh over the ranks of this node: every rank makes
    the group of each node, in node order, and keeps its own."""
    from rendering_tpu_torch.parallel.shard import make_ray_mesh

    if not dist.is_initialized():
        return make_ray_mesh(device=device)
    world = dist.get_world_size()
    per_node = local_world_size()
    mine = None
    for lo in range(0, world, per_node):
        ranks = list(range(lo, min(world, lo + per_node)))
        group = dist.new_group(ranks, timeout=TIMEOUT)
        if dist.get_rank() in ranks:
            mine = group
    return make_ray_mesh(group=mine, device=device)


def process_topology() -> dict:
    """The distributed topology as a dict: this rank and the rank count,
    the cards visible on this node, the devices in use (one a rank) and
    the platform."""
    up = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": dist.get_world_size() if up else 1,
        "platform": "gpu" if cuda else "cpu",
        "backend": dist.get_backend() if up else None,
    }


def scaling_report(rays_per_sec_1chip: float, rays_per_sec_n: float,
                   n_chips: int) -> dict:
    """Scaling-efficiency record for the north-star metric
    (BASELINE.json: >= 80% efficiency 1 chip -> 1 host -> >= 2 hosts)."""
    ideal = rays_per_sec_1chip * n_chips
    return {
        "n_chips": n_chips,
        "rays_per_sec": rays_per_sec_n,
        "ideal": ideal,
        "efficiency": rays_per_sec_n / ideal if ideal else 0.0,
    }
