"""Readings that set the limits of ``correct``: one process runs a cell on
several seeds, each a whole run at the cell's own size (a window of
``--seconds``), with the controls computed on the same inputs, and prints
one JSON line a seed.

    python3 bench/readings.py --workload <cell> --seeds 11,12,13 --seconds 10

The lower reading of a number is the largest the program gives over a dozen
seeds or more; the upper reading is the smallest its control gives.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    bench_run.pin_caches(bench_run.ROOT)
    import torch

    from bench import spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    bench = spec.benchmark(bench_run.ROOT)
    cell = spec.load_cell(args.workload, bench_run.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = bench_run.run_cell(cell, bench, seed, args.seconds, False,
                                 torch.device("cuda", 0), control=bool(args.control))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "checks": res["checks"], "metrics": res["metrics"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
