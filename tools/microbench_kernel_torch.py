#!/usr/bin/env python3
"""Grid costs and the pair test's product on the card: the PyTorch +
CUDA port's counterpart of tools/microbench_kernel.py, through the probes
of rendering_tpu_torch/ops/microbench.py.

    python3 tools/microbench_kernel_torch.py

1. Grid overhead (K8), in both forms, over one (8, 1024) block at the
   JAX tool's 16384 and 4096 steps and at 1: one launch of n_steps CTAs
   (`grid_overhead`; per-CTA cost = (t(16384) - t(1)) / 16383), and one
   launch of a CTA per SM taking the steps in turn, a barrier each
   (`grid_overhead_loop`, the TPU probe's form; per-step cost likewise).
2. What a one-CTA launch costs against `x.clone()`: the empty launch
   (no copy) of both forms, the copy, `x.clone()`, `y.copy_(x)` and a
   PyTorch elementwise kernel (`torch.neg`) on the block, each by device
   time; and the host's time per call through ctypes and per clone.
3. The pair product (K9), 2048 steps over 64 cycled coef tables, at the
   JAX tool's eleven configurations (tools/microbench_kernel.py:145-154,
   the first at highest and default precision, the rest at highest), and
   the four epilogue configurations again at default: the TF32
   tensor-core price of the pair test beside its f32 SIMT price
   (`pair_product`). Each row carries its bounds (`pair_bounds`): the
   product's operations at the data sheet's rate, the f32 form's own
   ceiling without FMA, and the epilogue's SIMT instructions. The inputs
   are the JAX tool's (feats 1, coef 1e-4); o_init is 0, or 3.0e38 with
   the epilogue (the TPU kernel read its output uninitialised; the port
   takes it as an input).

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
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rendering_tpu_torch.device import (  # noqa: E402
    describe_card,
    resolve_device,
)
from rendering_tpu_torch.ops import microbench as mb  # noqa: E402
from rendering_tpu_torch.ops.microbench import (  # noqa: E402
    F32_FLOPS_RATE,
    F32_OPS_RATE,
    HBM_RATE,
)
from rendering_tpu_torch.utils.timer import mean_ms  # noqa: E402

REPS = 20
BR = 1024
# The TF32 tensor cores' dense data-sheet rate (H100 SXM, 700 W); the
# f32 and HBM rates are the port's (ops/microbench.py).
TF32_FLOPS_RATE = 495e12
HOST_CALLS = 200                # the launch probe's host-timed calls
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


def pair_bounds(*, tc: int, br: int, k: int, n_steps: int, precision: str,
                epilogue: bool) -> dict:
    """K9's least times in ms on the data sheet's rates: the product's
    operations (2 x 4 tc x br x k a step; f32 counted as FMAs, or TF32),
    the f32 form's own ceiling (its multiply and add issue apart, as the
    bit-equal k-order sum needs), the epilogue's SIMT instructions
    (`mb.pair_epilogue_ops`), and the bytes read and written once. The
    operations bound adds the epilogue to an f32 product (both run on the
    SIMT lanes) and takes the larger beside a TF32 one (tensor cores and
    SIMT lanes run side by side)."""
    flops = mb.pair_flops(tc=tc, br=br, k=k, n_steps=n_steps)
    epi = (mb.pair_epilogue_ops(tc=tc, br=br, n_steps=n_steps)
           if epilogue else 0)
    epi_ms = epi / F32_OPS_RATE * 1e3
    if precision == "highest":
        product_ms = flops / F32_FLOPS_RATE * 1e3
        own_ms = flops / F32_OPS_RATE * 1e3 + epi_ms
        ops_ms = product_ms + epi_ms
    else:
        product_ms = flops / TF32_FLOPS_RATE * 1e3
        own_ms = None
        ops_ms = max(product_ms, epi_ms)
    bytes_ms = pair_bytes(tc=tc, br=br, k=k) / HBM_RATE * 1e3
    return {"flops": flops, "epilogue_ops": epi, "product_ms": product_ms,
            "epilogue_ms": epi_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "nofma_ms": own_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def grid_probe(*, device, n_steps: int, br: int = BR, reps: int = REPS,
               form: str = "ctas") -> dict:
    x = torch.ones((8, br), dtype=torch.float32, device=device)
    fn = mb.grid_overhead if form == "ctas" else mb.grid_overhead_loop
    return {"form": form, "n_steps": n_steps, "br": br, "device": str(device),
            "ms": mean_ms(lambda: fn(x, n_steps), reps, device),
            "bytes": grid_bytes(br)}


def launch_probe(*, device, br: int = BR, reps: int = REPS,
                 host_calls: int = HOST_CALLS) -> dict:
    """Device ms of a one-CTA launch with and without its copy, beside
    PyTorch's copies and an elementwise kernel of its own on the same
    block; host us per call through ctypes and per clone."""
    x = torch.ones((8, br), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    empty = torch.empty((0,), dtype=torch.float32, device=device)
    probes = {
        "empty_ctas": lambda: mb.grid_overhead(empty, 1),
        "empty_loop": lambda: mb.grid_overhead_loop(empty, 1),
        "copy_ctas": lambda: mb.grid_overhead(x, 1),
        "copy_loop": lambda: mb.grid_overhead_loop(x, 1),
        "clone": lambda: x.clone(),
        "copy_": lambda: y.copy_(x),
        "torch_neg": lambda: torch.neg(x, out=y),
    }
    out = {"device": str(device)}
    out.update({f"{name}_ms": mean_ms(fn, reps, device)
                for name, fn in probes.items()})
    for name in ("copy_ctas", "clone"):
        t0 = time.perf_counter()
        for _ in range(host_calls):
            probes[name]()
        out[f"host_us_{name}"] = (time.perf_counter() - t0) / host_calls * 1e6
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out


def pair_probe(*, device, tc: int, br: int, k: int, precision: str,
               epilogue: bool, n_steps: int = N_STEPS, reps: int = REPS
               ) -> dict:
    feats, coef, o_init = tool_inputs(tc=tc, br=br, k=k, epilogue=epilogue,
                                      device=device)
    ms = mean_ms(mb.pair_product_fn(
        feats, coef, o_init, tc=tc, n_steps=n_steps, precision=precision,
        epilogue=epilogue), reps, device)
    bounds = pair_bounds(tc=tc, br=br, k=k, n_steps=n_steps,
                         precision=precision, epilogue=epilogue)
    return {"tc": tc, "br": br, "k": k, "precision": precision,
            "epilogue": epilogue, "n_steps": n_steps,
            "device": str(device), "ms": ms,
            "us_per_step": ms * 1e3 / n_steps,
            "bytes": pair_bytes(tc=tc, br=br, k=k), **bounds}


def measure(device, *, grid_steps=GRID_STEPS, br: int = BR,
            configs=CONFIGS, n_steps: int = N_STEPS,
            reps: int = REPS) -> dict:
    """Every grid-overhead, launch and pair-product probe on `device`:
    `grid`/`grid_loop` K8's two forms, `pair` K9."""
    return {
        "grid": [grid_probe(device=device, n_steps=s, br=br, reps=reps)
                 for s in grid_steps],
        "grid_loop": [grid_probe(device=device, n_steps=s, br=br, reps=reps,
                                 form="loop") for s in grid_steps],
        "launch": launch_probe(device=device, br=br, reps=reps),
        "pair": [pair_probe(device=device, tc=tc, br=b, k=k, precision=p,
                            epilogue=e, n_steps=n_steps, reps=reps)
                 for tc, b, k, p, e in configs],
    }


def expected_launches(*, grid_steps=GRID_STEPS, configs=CONFIGS,
                      reps: int = REPS, host_calls: int = HOST_CALLS) -> dict:
    """The kernel launches one `measure` on a card makes, by launch count
    (`mb.KERNELS`): each timed call runs reps + 1 times (`mean_ms`'s
    warm-up), the launch probe's host timing host_calls more; K9's TF32
    calls pack their tables first, and its calls without the epilogue end
    in the recurrence."""
    calls = reps + 1
    out = {"grid_overhead": (len(grid_steps) + 2) * calls + host_calls,
           "grid_overhead_loop": (len(grid_steps) + 2) * calls}
    for _, _, _, p, e in configs:
        name = mb.pair_name(p, e)
        out[name] = out.get(name, 0) + calls
        if p == "default":
            out["pair_pack_tf32"] = out.get("pair_pack_tf32", 0) + calls
        if not e:
            out["pair_recurrence"] = out.get("pair_recurrence", 0) + calls
    return out


def summary(raw: dict, card_line: str) -> dict:
    """The tool's JSON from `measure`'s results, which must come from a
    card: the launch (the one-CTA grid) and the cost per further CTA, and
    each product's time per step and rate."""
    for r in (*raw["grid"], *raw["grid_loop"], raw["launch"], *raw["pair"]):
        if not r["device"].startswith("cuda"):
            raise ValueError(f"no device time from a {r['device']} run")

    def per_step(rows):
        ms = {r["n_steps"]: r["ms"] for r in rows}
        lo, hi = min(ms), max(ms)
        return ms, (ms[hi] - ms[lo]) / (hi - lo) * 1e6

    grid, per_cta = per_step(raw["grid"])
    loop, per_loop_step = per_step(raw["grid_loop"])
    return {
        "card": card_line,
        "launch_ms": grid[min(grid)],
        "per_cta_ns": per_cta,
        "per_step_ns": per_loop_step,
        "grid_ms": grid,
        "grid_loop_ms": loop,
        "launch": raw["launch"],
        "pair": [dict(r, tflops=r["flops"] / (r["ms"] * 1e-3) / 1e12,
                      bound_share=r["bound_ms"] / r["ms"])
                 for r in raw["pair"]],
    }


def main() -> int:
    device = resolve_device()
    line = describe_card()
    print(line)
    raw = measure(device)
    out = summary(raw, line)
    for r in (*raw["grid"], *raw["grid_loop"]):
        print(f"grid overhead ({r['form']}): {r['n_steps']} steps -> "
              f"{r['ms']:.5f} ms ({r['ms'] / r['n_steps'] * 1e6:.1f} ns/step)")
    print(f"per further CTA {out['per_cta_ns']:.3f} ns; per loop step "
          f"{out['per_step_ns']:.3f} ns; launch: {json.dumps(out['launch'])}")
    for r in out["pair"]:
        print(f"mm tc={r['tc']} br={r['br']} k={r['k']} prec="
              f"{r['precision']} epi={r['epilogue']}: {r['ms']:.5f} ms, "
              f"{r['us_per_step']:.3f} us/step ({r['tflops']:.2f} TFLOP/s "
              f"nominal; bound {r['bound_ms']:.5f} ms, "
              f"{r['bound_share']:.1%})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
