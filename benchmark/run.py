"""Run one cell of the benchmark of rendering_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output, and each number compared with the reference beside its
limit as the last lines of standard error. Needs a CUDA device; the cell
files are found by name under benchmark/ (harness/registry.py).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Every cache of the program lives inside the checkout, at a fixed path.
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
sys.path[:0] = [ROOT, BENCH]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import registry, runner

    chips = next((w["chips"] for w in registry.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import rendering_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test is missing: {exc}", file=sys.stderr)
        return 3
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    runner.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
