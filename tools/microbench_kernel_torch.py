#!/usr/bin/env python3
"""Per-CTA cost and the pair test's product on the card: the PyTorch +
CUDA port's counterpart of tools/microbench_kernel.py, through the probes
of rendering_tpu_torch/ops/microbench.py.

    python3 tools/microbench_kernel_torch.py

1. Grid overhead (K8): one launch of n_steps CTAs that revisit one
   (8, 1024) block, at the JAX tool's 16384 and 4096 steps, and at 1 (the
   empty grid: the launch with CTA 0's copy of the block); per-CTA cost =
   (t(16384) - t(1)) / 16383.
2. The pair product (K9), 2048 steps over 64 cycled coef tables, at the
   JAX tool's eleven configurations (tools/microbench_kernel.py:145-154,
   the first at highest and default precision, the rest at highest), and
   the four epilogue configurations again at default: the TF32
   tensor-core price of the pair test beside its f32 SIMT price. The
   inputs are the JAX tool's (feats 1, coef 1e-4); o_init is 0, or
   3.0e38 with the epilogue (the TPU kernel read its output
   uninitialised; the port takes it as an input).

Each time is the mean of 20 launches after a warm-up, by CUDA events
with the launches queued behind a ~2 ms spin (`utils.timer.mean_ms`); K9's
inputs are checked once, outside the timed launches (`pair_product_fn`).
Prints the card's name and power limit, a line per probe, and one JSON
line with every result. Raises without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rendering_tpu_torch.device import (  # noqa: E402
    describe_card,
    resolve_device,
)
from rendering_tpu_torch.ops import microbench as mb  # noqa: E402
from rendering_tpu_torch.utils.timer import mean_ms  # noqa: E402

REPS = 20
BR = 1024
GRID_STEPS = (1, 16384, 4096)   # 1 = the empty grid; then the JAX tool's
N_STEPS = 2048
# tools/microbench_kernel.py:145-154 in its order: (tc, br, k, precision,
# epilogue).
JAX_CONFIGS = (
    (256, 1024, 13, "highest", False), (256, 1024, 13, "default", False),
    (256, 1024, 128, "highest", False), (256, 2048, 13, "highest", False),
    (256, 512, 13, "highest", False), (256, 256, 13, "highest", False),
    (512, 1024, 13, "highest", False), (256, 1024, 13, "highest", True),
    (256, 512, 13, "highest", True), (256, 2048, 13, "highest", True),
    (128, 1024, 13, "highest", True),
)
CONFIGS = JAX_CONFIGS + tuple((tc, br, k, "default", True)
                              for tc, br, k, _, epi in JAX_CONFIGS if epi)


def grid_bytes(br: int) -> int:
    """K8's data: the (8, br) block read and written once."""
    return 2 * 8 * br * 4


def pair_bytes(*, tc: int, br: int, k: int, n_tab: int = mb.N_TAB) -> int:
    """K9's data read or written once: the tables, feats, o_init, o."""
    return 4 * (n_tab * 4 * tc * k + k * br + 2 * br)


def tool_inputs(*, tc: int, br: int, k: int, epilogue: bool, device):
    """The JAX tool's feats (ones) and coef (1e-4), and o_init."""
    feats = torch.ones((k, br), dtype=torch.float32, device=device)
    coef = torch.full((mb.N_TAB, 4 * tc, k), 1e-4, dtype=torch.float32,
                      device=device)
    o_init = torch.full((1, br), mb.T_NONE if epilogue else 0.0,
                        dtype=torch.float32, device=device)
    return feats, coef, o_init


def grid_probe(*, device, n_steps: int, br: int = BR,
               reps: int = REPS) -> dict:
    x = torch.ones((8, br), dtype=torch.float32, device=device)
    return {"n_steps": n_steps, "br": br, "device": str(device),
            "ms": mean_ms(lambda: mb.grid_overhead(x, n_steps), reps,
                                device),
            "bytes": grid_bytes(br)}


def pair_probe(*, device, tc: int, br: int, k: int, precision: str,
               epilogue: bool, n_steps: int = N_STEPS,
               reps: int = REPS) -> dict:
    feats, coef, o_init = tool_inputs(tc=tc, br=br, k=k, epilogue=epilogue,
                                      device=device)
    ms = mean_ms(mb.pair_product_fn(
        feats, coef, o_init, tc=tc, n_steps=n_steps, precision=precision,
        epilogue=epilogue), reps, device)
    return {"tc": tc, "br": br, "k": k, "precision": precision,
            "epilogue": epilogue, "n_steps": n_steps, "device": str(device),
            "ms": ms, "us_per_step": ms * 1e3 / n_steps,
            "flops": mb.pair_flops(tc=tc, br=br, k=k, n_steps=n_steps),
            "bytes": pair_bytes(tc=tc, br=br, k=k)}


def measure(device, *, grid_steps=GRID_STEPS, br: int = BR,
            configs=CONFIGS, n_steps: int = N_STEPS,
            reps: int = REPS) -> dict:
    """Every grid-overhead and pair-product probe on `device`."""
    return {
        "grid": [grid_probe(device=device, n_steps=s, br=br, reps=reps)
                 for s in grid_steps],
        "pair": [pair_probe(device=device, tc=tc, br=b, k=k, precision=p,
                            epilogue=e, n_steps=n_steps, reps=reps)
                 for tc, b, k, p, e in configs],
    }


def summary(raw: dict, card_line: str) -> dict:
    """The tool's JSON from `measure`'s results, which must come from a
    card: the launch (the one-CTA grid) and the cost per further CTA, and
    each product's time per step and rate."""
    for r in (*raw["grid"], *raw["pair"]):
        if not r["device"].startswith("cuda"):
            raise ValueError(f"no device time from a {r['device']} run")
    grid = {r["n_steps"]: r["ms"] for r in raw["grid"]}
    most = max(grid)
    return {
        "card": card_line,
        "launch_ms": grid[min(grid)],
        "per_cta_ns": (grid[most] - grid[min(grid)]) / (most - min(grid)) * 1e6,
        "grid_ms": grid,
        "pair": [dict(r, tflops=r["flops"] / (r["ms"] * 1e-3) / 1e12)
                 for r in raw["pair"]],
    }


def main() -> int:
    device = resolve_device()
    line = describe_card()
    print(line)
    raw = measure(device)
    out = summary(raw, line)
    for r in raw["grid"]:
        print(f"grid overhead: {r['n_steps']} CTAs -> {r['ms']:.5f} ms "
              f"({r['ms'] / r['n_steps'] * 1e6:.1f} ns/CTA)")
    for r in out["pair"]:
        print(f"mm tc={r['tc']} br={r['br']} k={r['k']} prec="
              f"{r['precision']} epi={r['epilogue']}: {r['us_per_step']:.3f} "
              f"us/step ({r['tflops']:.2f} TFLOP/s nominal)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
