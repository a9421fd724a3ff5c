"""Readings that the limits of `correct` are set from, for one cell, in
one process: for each seed the program's gaps to the reference (the
lower readings), the gaps of the reference computed in bfloat16 put in
the program's place (the control, the upper readings), and on the first
`--fault-seeds` seeds the gaps of the program with each fault its cell
can have (harness/faults.py). The benchmark's runs do not run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--requests 2] [--fault-seeds 3]

Prints one JSON line per seed and fault.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import types

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
sys.path[:0] = [ROOT, BENCH]


def _state(kind, ctx, n_requests, runner):
    state = kind.setup(ctx)
    records = [runner._request(kind, state) for _ in range(n_requests)]
    kind.finish(state, records)
    kind.release(state)
    return state, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="scene settings as JSON (a CPU rehearsal: "
                         "'{\"width\": 64, \"height\": 48, \"n_tris\": 2000}')")
    args = ap.parse_args(argv)

    import torch

    from harness import faults, registry, runner

    cell = registry.workload(args.workload)
    kind = registry.traffic(cell["traffic"])
    cfg = registry.config(cell["config"])
    device = torch.device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="rtcal-") as wd:
            ctx = types.SimpleNamespace(name=args.workload, cell=cell, cfg=cfg,
                                        seed=seed, device=device, workdir=wd,
                                        overrides=json.loads(args.overrides))
            state, records = _state(kind, ctx, args.requests, runner)
            line = {"seed": seed,
                    "lower": kind.check(state, records, torch.float32),
                    "control": kind.control(state, records, torch.bfloat16)}
            if i < args.fault_seeds:
                for name in faults.KIND_FAULTS[cell["traffic"]]:
                    with faults.FAULTS[name]():
                        fstate, frec = _state(kind, ctx, args.requests, runner)
                    if cell["traffic"] == "train":
                        fstate["ref_cache"] = state["ref_cache"]
                    line[name] = kind.check(fstate, frec, torch.float32)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
