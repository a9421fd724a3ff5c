"""Where one cell's traced requests spend their time, by the program's
own spans.

    python3 benchmark/breakdown.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a CUDA device. Runs the cell once as
`run.py --trace 1` does (the same `runner.run_cell`), keeps the trace
the runner reads and reports it through harness/spans.py. Prints one
JSON line: the runner's result under "result", and per traced request
the device's idle ms under each innermost span of the main thread and
the share under any span, the kernel ms by innermost span, the span
stacks of the heaviest kernels (a backward kernel's with its forward
operator), the host's synchronize calls in all and those no `rt.sync.`
span holds, and the count of each span.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
sys.path[:0] = [ROOT, BENCH]


def report(trace, n: int) -> dict:
    """The span report of a traced window of n requests (per request)."""
    from harness import spans

    sp = spans.of(trace)
    idle = sp.idle_by_span()
    idle_s = sum(idle.values())
    heavy: dict = {}
    for held, s, kname, op in sp.charges:
        key = " > ".join(held) or "(none)"
        if op is not None:
            key += f" (backward of {op})"
        heavy.setdefault(kname, {})
        heavy[kname][key] = heavy[kname].get(key, 0.0) + s
    top = sorted(heavy, key=lambda k: -sum(heavy[k].values()))[:5]
    unspanned = sp.unspanned_syncs()
    names: dict = {}
    for nm in sp.names:
        names[nm] = names.get(nm, 0) + 1
    per_ms = 1e3 / n

    def by_ms(d):
        return {str(k): v * per_ms
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    return {
        "idle_ms": idle_s * per_ms,
        "idle_under_span_share": ((idle_s - idle.get(None, 0.0)) / idle_s
                                  if idle_s else None),
        "idle_ms_by_span": by_ms(idle),
        "kernel_ms_by_span": by_ms(sp.kernel_by_span()),
        "heaviest_kernels": {k[:120]: dict(list(by_ms(heavy[k]).items())[:6])
                             for k in top},
        "sync_calls": len(sp.syncs()) / n,
        "program_sync_calls": sum(1 for s in sp.syncs() if s[2]) / n,
        "unspanned_syncs": len(unspanned),
        "unspanned_sync_spans": sorted({str(u[2]) for u in unspanned}),
        "span_counts": {k: v / n for k, v in sorted(names.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from harness import registry, runner
    from harness.trace import Trace

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    kept = []
    load = runner.load

    def keep(path):
        kept.append(load(path))
        return kept[-1]

    runner.load = keep
    result = runner.run_cell(args.workload, args.seed, args.seconds, True,
                             t_start=T_START)
    n = int(registry.workload(args.workload).get("trace_requests", 1))
    print(json.dumps({"result": result, "spans": report(Trace(kept[0]), n)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
