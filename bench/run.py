"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (``setup_s``) runs from the start of
this script to the end of the warm rounds.  With ``--trace 0`` the line
carries the cell's end-to-end metrics; with ``--trace 1`` the window runs
with the harness's spans and under the profiler, and the line carries its
per-layer metrics, ``busy_s``, ``window_s`` and a ``breakdown``.  Either way the window's outputs are then
held to the plain references (``check.py``), and the numbers compared are
printed beside their limits, last on standard error and last in the line.
The last line of standard output is one JSON object.

Refuses to run without a CUDA card, with ``RESERVOIR_SANITIZE``,
``RESERVOIR_PROFILE`` or ``RESERVOIR_TRACE`` set, or in a checkout without
the program; and prints no result if JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REFUSED_ENV = ("RESERVOIR_SANITIZE", "RESERVOIR_PROFILE", "RESERVOIR_TRACE")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_caches(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout (the
    program's kernels build into ``build/kernels/`` by themselves); the
    checkout and its ``src`` on the path, this script's folder off it (its
    modules are imported as ``bench.*``)."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool, device, *,
             arch=None, t0: float = None, limits: dict = None, control: bool = False) -> dict:
    """Set-up, window and check of one cell on ``device``: the result line.
    ``arch`` and ``limits`` replace the configuration's (the CPU tests run a
    reduced model).  ``control`` adds the controls' readings on the same
    inputs (``readings.py``; a benchmark run never takes them)."""
    import numpy as np
    import torch

    from bench import check, spec
    from bench.cell import CellRun, latencies_ms, percentile
    from bench.trace import Profiler, Trace, device_block

    t0 = time.perf_counter() if t0 is None else t0
    say(f"process start to set-up: {time.perf_counter() - t0:.3f} s")
    run = CellRun(cell, seed, device, arch=arch, log=say)
    run.setup()
    setup_s = time.perf_counter() - t0
    say(f"set-up {setup_s:.3f} s; {len(run.rounds)} warm rounds")

    tr = None
    if trace:
        spans = run.instrument()
        with Profiler(device) as prof:
            start = time.perf_counter_ns()
            run.window(seconds)
            end = time.perf_counter_ns()
        tr = Trace(run.window_s, run.window_rounds(), run.clients, cell.config, spans,
                   start, end, prof.events())
    else:
        run.window(seconds)
    rounds = run.window_rounds()
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    tasks = sum(len(r) for r in rounds)
    failed = sum(int((r.kind < 0).sum()) for r in rounds)
    lat = latencies_ms(rounds, run.clients)
    say(f"window {run.window_s:.3f} s, {len(rounds)} rounds, {tasks} tasks; "
        f"round ms p50 {percentile(lat, 50):.3f} p95 {percentile(lat, 95):.3f}")
    if trace:
        metrics = {}
        for m in spec.metrics_of(bench, cell.name, "per_layer"):
            v = spec.metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"tasks_per_s": tasks / run.window_s, "task_p95_ms": percentile(lat, 95),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec.metrics_of(bench, cell.name, "end_to_end")}
    from repro_torch.kernels import ops
    launches = ops.launch_counts()
    if device.type == "cuda":
        say(f"card: {power_limit()}")

    # ---- correct: the window's outputs against the plain references
    xs = [run.x[r.index] for r in run.rounds]
    ids = [[r.index * run.clients + k for k in range(run.clients)] for r in run.rounds]
    answers = [check.answers_of(r.results()) for r in run.rounds]
    served = {a.result[0]: a.result[1] for rnd in answers for a in rnd
              if a is not None and a.kind is None and isinstance(a.result, tuple)}
    fill, pool = (run.fill_rows, run.fill_owners, run.fill_buckets), run.pool
    routes, names = [r.route for r in run.rounds], [r.names for r in run.rounds]
    captured = run.release()["captured"]
    t_check = time.perf_counter()
    full = check.full_rounds(answers, seed, int(cell.params["judge_queries"]))
    ref = check.judge_reuse(cell.deployment, fill, xs, ids, answers, routes, names, full, device)
    values = {"reuse_wrong": float(ref.n_wrong)}
    t_judge = time.perf_counter() - t_check
    task_ids = [t for ids_, _ in captured for t in ids_]
    if task_ids:
        program = torch.cat([lg for _, lg in captured])
        tokens = torch.from_numpy(np.stack([pool[t % len(pool)] for t in task_ids]))
        served_tok = torch.as_tensor([int(served.get(t, -1)) for t in task_ids])
        values.update(check.model_numbers(cell.config, seed, device, tokens, served_tok,
                                          program, control=control))
    else:
        values.update(token_gap=float("inf"), logit_err=float("inf"))
    limits = cell.config["check"] if limits is None else limits
    least = int(cell.params["check_tasks"]) // 2
    correct = check.verdict(values, limits) and failed == 0 and len(task_ids) >= least
    say(f"reuse check: {ref.checked} answers held to the rules, {ref.full_checked} store "
        f"answers against their candidates, wrong {ref.wrong} {ref.examples}; model check: "
        f"{len(task_ids)} executed tasks; {t_judge:.3f} s + {time.perf_counter() - t_check - t_judge:.3f} s")
    say(f"launches {launches}")

    result = {"correct": bool(correct), "attempted": tasks, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": peak, **device_block(tr)}}
    if tr is not None and tr.events:
        result["breakdown"] = tr.breakdown()
    checks = {k: {"value": values[k], "limit": limits[k]} for k in check.NUMBERS}
    checks["checked_tasks"] = {"value": len(task_ids), "at_least": least}
    if control:
        ctrl = check.control_reuse(cell.deployment, fill[0], xs, ids, full, device)
        values["control_reuse_wrong"] = float(ctrl.n_wrong)
        say(f"control reuse: wrong {ctrl.wrong} {ctrl.examples}")
        checks.update({k: {"value": v} for k, v in values.items() if k.startswith("control")})
    result["checks"] = checks
    for line in check.lines(values, limits):
        say(line)
    say(f"check checked_tasks {len(task_ids)} at least {least}")
    return result


def main(argv=None) -> int:
    pin_caches(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    refused = [k for k in REFUSED_ENV if os.environ.get(k)]
    if refused:
        say(f"refusing to run with {refused} set: they change the timed path")
        return 2
    import torch

    from bench import spec
    bench = spec.benchmark(ROOT)
    entry = spec.workload(bench, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(entry["chips"]):
        say(f"needs {entry['chips']} CUDA card(s), found {have}")
        return 2
    result = run_cell(spec.load_cell(args.workload, ROOT), bench, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t0=T0)
    found = forbidden_modules()
    if found:
        say(f"JAX or the JAX package was loaded: {found[:10]}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
