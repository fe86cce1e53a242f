"""The readers of the program's own spans (``spans.py`` and the six metrics
that read them), on the CPU tiny cell: a traced run whose window the
program's wall recorder records, its device trace made up from the spans
in which the host waits for the device (no card here)."""
import json

import numpy as np
import pytest
import torch

from bench import run as bench_run
from bench import spans
from bench.cell import CellRun
from bench.spec import ROOT
from bench.tiny import LIMITS, tiny_cell
from bench.trace import Profiler, Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 123
NEW = ("fleet_ms", "cs_ms", "query_wait_ms", "evict_ms", "upload_mb", "idle_unspanned_ms")
WAITS = ("store.read", "executor.read")     # the host waits for the device inside these


@pytest.fixture
def armed_by_profiler(monkeypatch):
    """The program sees a profiler recording, as in a traced run on the
    card; its recorder is disarmed again afterwards."""
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    yield obs_trace
    obs_trace.disarm_wall()


@pytest.fixture
def made_up_device(monkeypatch):
    """Device operations where the program waits for the device."""
    def events(self):
        from repro_torch.obs import trace as obs_trace
        return [(name, s, e - s) for _, _, name, s, e, _ in obs_trace.wall().spans
                if name in WAITS]
    monkeypatch.setattr(Profiler, "events", events)


def traced(mix, monkeypatch):
    """A traced tiny run -> (result line, the Trace its readers read)."""
    seen = {}
    real = spans.recorded

    def recorded(t):
        seen["t"] = t
        return real(t)
    monkeypatch.setattr(spans, "recorded", recorded)
    cell, arch = tiny_cell(mix)
    res = bench_run.run_cell(cell, BENCH, SEED, 0.6, True, torch.device("cpu"), arch=arch,
                             limits=LIMITS)
    return res, seen["t"]


@pytest.mark.parametrize("mix", ["cctv", "fresh"])
def test_traced_run_reports_the_program_span_metrics(mix, monkeypatch, armed_by_profiler,
                                                     made_up_device):
    res, t = traced(mix, monkeypatch)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    for name in ("fleet_ms", "cs_ms", "upload_mb"):
        assert m[name] > 0, name
    # fresh: every task queries (the fused path at 80 a replica) and inserts
    # at capacity; cctv's few misses a replica may query on the staged path
    for name in ("query_wait_ms", "evict_ms"):
        assert m[name] > 0 if mix == "fresh" else m[name] >= 0, name
    # the split of the idle time covers it exactly
    idle = spans.idle_by_span(t, spans.recorded(t))
    window = (t.end_ns - t.start_ns) / 1e9
    assert sum(idle.values()) == pytest.approx(window - t.busy_s(), rel=1e-9)
    assert m["idle_unspanned_ms"] == pytest.approx(1e3 * idle["unspanned"] / len(t.rounds))
    assert "replica.cs" in idle and "fleet.submit" in idle
    # the readers agree with the spans they read
    inside = spans.inside(t, spans.recorded(t))
    cs = sum(e - s for _, _, n, s, e, _ in inside if n == "replica.cs")
    assert m["cs_ms"] == pytest.approx(cs / 1e6 / len(t.rounds))
    assert 0 < m["fleet_ms"] < max(e - s for _, _, n, s, e, _ in inside
                                   if n == "fleet.submit") / 1e6


def test_a_window_the_program_did_not_record_reads_nothing():
    """Disarmed (an untraced run; a program without the recorder),
    the six readers return nothing and the line leaves them out."""
    cell, arch = tiny_cell("cctv")
    res = bench_run.run_cell(cell, BENCH, SEED, 0.3, True, torch.device("cpu"), arch=arch,
                             limits=LIMITS)
    assert res["correct"] and not set(NEW) & set(res["metrics"])


def _trace(events, start=0, end=100):
    return Trace(1e-7, [object()], 1, {}, None, start, end, events)


def test_idle_by_span_splits_at_span_edges():
    """A gap that crosses span edges is split there, each piece to the
    innermost span open over it; the pieces sum to the idle time."""
    t = _trace([("k", 10, 10), ("k", 60, 20)])               # busy [10,20) and [60,80)
    got = [(1, 0, "fleet.submit", 5, 95, None), (2, 1, "replica.handle", 15, 70, None),
           (3, 2, "replica.cs", 30, 40, None), (4, 3, "gc", 32, 34, None)]
    idle = spans.idle_by_span(t, got)
    assert idle == pytest.approx({"unspanned": 10e-9, "fleet.submit": 20e-9,
                                  "replica.handle": 30e-9, "replica.cs": 8e-9, "gc": 2e-9})
    assert sum(idle.values()) == pytest.approx(1e-7 - t.busy_s())


def test_idle_by_span_clips_spans_to_the_window():
    t = _trace([], start=100, end=200)
    got = [(1, 0, "fleet.submit", 50, 150, None), (2, 0, "fleet.submit", 180, 250, None)]
    assert spans.idle_by_span(t, got) == pytest.approx(
        {"fleet.submit": 70e-9, "unspanned": 30e-9})


def test_self_time_leaves_out_the_children():
    got = [(1, 0, "fleet.submit", 0, 100, None), (2, 1, "router.route", 10, 20, None),
           (3, 1, "replica.handle", 30, 80, None), (4, 3, "replica.cs", 40, 50, None),
           (5, 0, "fleet.submit", 200, 230, None), (6, 5, "gc", 210, 215, None)]
    assert spans.self_ns(got, "fleet.submit") == 40 + 25


def _rounds(armed: bool, n: int = 6):
    from repro_torch.obs import trace as obs_trace
    cell, arch = tiny_cell("cctv")
    if armed:
        obs_trace.arm_wall()
    try:
        run = CellRun(cell, SEED, torch.device("cpu"), arch=arch, log=lambda msg: None)
        run.setup()
        for _ in range(n):
            run.window(0.0)             # one round each
        recorded = len(obs_trace.wall().spans) if armed else 0
    finally:
        obs_trace.disarm_wall()
    return run.rounds, recorded


def test_arming_leaves_the_answers_as_they_were():
    plain, _ = _rounds(False)
    armed, recorded = _rounds(True)
    assert recorded > 0 and len(plain) == len(armed)
    for a, b in zip(plain, armed):
        for field in ("replica", "kind", "key", "token", "sim", "route", "names"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
