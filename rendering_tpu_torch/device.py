"""Device selection shared by the port's entry points, the card's name
and power limit for its measuring tools, and the deterministic-algorithms
mode of its train step."""

from __future__ import annotations

import contextlib
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA device. Raises when no device is given and no GPU is visible —
    the port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def describe_card() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them: every
    time a tool reports stands beside them (a card capped below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) for the block, then the
    previous mode: on CUDA, an op whose backward may accumulate with
    atomics (the gathers vgeoT[:, idx], the texture and skybox gathers)
    takes its deterministic kernel or raises. The per-object tables'
    gathers and the radiance scatters need no mode: they accumulate
    through `ops.accumulate`'s kernel, whose order of summation follows
    from the ids alone. The mode's other effect, filling
    every new tensor with NaN (torch.utils.deterministic.
    fill_uninitialized_memory), is off for the block: it guards against
    reading memory before writing it and decides no bit of a result, and
    it cost ~13% of the flagship step on an H100 (PERF.md)."""
    import torch.utils.deterministic as det

    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    prev_fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = prev_fill
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
