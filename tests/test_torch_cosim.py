"""The co-simulation (``EngineBackend`` behind ``ReservoirNetwork``) of the
port against the JAX package's, on the CPU.

* Mirrors of tests/test_cosim.py::TestEngineCosim on the port with
  ``device="cpu"``; each run also goes through the reference, and every task
  record and the engines' counters must be equal (virtual execution times:
  the clock does not depend on the host).
* Four rows of ``BENCH_cosim.json`` (the sweep of benchmarks/cosim.py,
  rebuilt here on both packages): every derived field equal to the JSON at
  its printed precision and to the reference's run.
* The launcher's ``--engine cosim --trace-out`` on the reduced model: every
  task completes, the records by reuse kind add up, and the trace holds one
  task span a task.  Its virtual durations are measured wall times, so
  nothing else of it can be compared with the reference.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
from repro.core.edge_node import Service as JService
from repro.core.topology import line_topology as jline
from repro.core.topology import testbed_topology as jtestbed
from repro.data import DATASETS as JDATASETS
from repro.data import dataset_service as jdataset_service
from repro.serving import EngineBackend as JEngineBackend
from repro.training.elastic import BackupPolicy as JBackup
from repro_torch.core.edge_node import Service
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.network import ReservoirNetwork
from repro_torch.core.topology import line_topology
from repro_torch.core.topology import testbed_topology as _testbed
from repro_torch.data import DATASETS, dataset_service, make_stream
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving import EngineBackend
from repro_torch.training.elastic import BackupPolicy

ROOT = Path(__file__).resolve().parents[1]


def _key(r):
    return (r.task_id, r.name, r.t_complete, r.reuse, r.similarity, r.correct,
            r.forwarding_error, r.reuse_node, r.aggregated, r.result)


def _same(port, ref, port_be, ref_be):
    assert [_key(r) for r in port.metrics.records] == [_key(r) for r in ref.metrics.records]
    assert port_be.stats() == ref_be.stats()
    for node in ref.edge_nodes:
        assert dict(port.edge_nodes[node].stats) == dict(ref.edge_nodes[node].stats)


# ------------------------------------------------------------ engine co-sim
def _engine_nets(protocol="direct", window=0.01, exec_time=(0.070, 0.100),
                 n_replicas=2, backend_kw=None, ref_backend_kw=None, link=1e-3):
    """tests/test_cosim.py::_engine_net on both packages."""
    out = []
    for port in (True, False):
        params = (LSHParams if port else J.LSHParams)(dim=16, num_tables=5, num_probes=8)
        g, ens = (line_topology if port else jline)(2, link_delay_s=link)
        be = (EngineBackend if port else JEngineBackend)(
            n_replicas=n_replicas, max_batch=8, max_wait_s=0.004, seed=3,
            **((backend_kw if port else ref_backend_kw) or {}))
        net = (ReservoirNetwork if port else J.ReservoirNetwork)(
            g, ens, params, seed=0, protocol=protocol, user_link_delay_s=link,
            en_batch_window_s=window, backend=be, **({"device": "cpu"} if port else {}))
        net.register_service((Service if port else JService)(
            "/svc", execute=lambda x: round(float(np.sum(x)), 5),
            exec_time_s=exec_time, input_dim=16))
        net.add_user("u1", 0)
        net.add_user("u2", 0)
        out.append((net, be))
    return out


def _stream(n, dim=16, seed=11, centers=6, noise=0.05):
    rng = np.random.default_rng(seed)
    base = normalize(rng.standard_normal((centers, dim)).astype(np.float32))
    picks = rng.integers(0, centers, n)
    return normalize(base[picks] + noise * rng.standard_normal((n, dim)).astype(np.float32))


def _drive(pairs, X, spacing):
    for net, _ in pairs:
        t = 0.0
        for i, x in enumerate(X):
            net.submit_task("u1" if i % 2 else "u2", "svc", x, 0.9, at_time=t)
            t += spacing
        net.run()
    (net, be), (jnet, jbe) = pairs
    _same(net, jnet, be, jbe)
    return net, be


class TestEngineCosim:
    @pytest.mark.parametrize("protocol", ["direct", "ttc"])
    def test_all_complete_with_attribution(self, protocol):
        net, be = _drive(_engine_nets(protocol=protocol), _stream(80), 0.008)
        assert all(r.t_complete >= 0 for r in net.metrics.records)
        es = be.stats()
        assert es["executed"] > 0
        en = net.edge_nodes[net.en_nodes[0]]
        assert en.stats["reused"] > 0 or es["en"] > 0
        assert not net._en_ready
        m = net.metrics
        assert m.mean_completion(kind=(None,)) > m.mean_completion(kind=("en", "cs", "user"))

    def test_ttc_answers_come_from_engine_estimator(self):
        pairs = _engine_nets(protocol="ttc", window=0.0, exec_time=0.2)
        for net, be in pairs:
            node = net.en_nodes[0]
            est0 = be.ttc_estimate(node, "svc")
            assert est0 == pytest.approx(
                be.engines[node].replicas[0].ttc.initial + be.max_wait_s)
            rec = net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0)
            net.run()
            assert rec.t_complete >= 0.2
            assert be.ttc_estimate(node, "svc") > est0
        (net, be), (jnet, jbe) = pairs
        _same(net, jnet, be, jbe)
        assert be.ttc_estimate(2, "svc") == jbe.ttc_estimate(2, "svc")

    def test_backup_win_propagates_to_network(self):
        def straggle_first():
            calls = []

            def exec_time_fn(rid, service, reqs):
                calls.append(rid)
                return 3.0 if len(calls) == 1 else 0.05

            return exec_time_fn

        pairs = _engine_nets(
            window=0.0,
            backend_kw={"backup": BackupPolicy(factor=1.5, max_backups=1),
                        "exec_time_fn": straggle_first()},
            ref_backend_kw={"backup": JBackup(factor=1.5, max_backups=1),
                            "exec_time_fn": straggle_first()})
        recs = []
        for net, be in pairs:
            for r in be.engines[net.en_nodes[0]].replicas:
                r.ttc.observe("svc", 0.05)
            recs.append(net.submit_task("u1", "svc", np.ones(16), 0.9, at_time=0.0))
            net.run()
        (net, be), (jnet, jbe) = pairs
        _same(net, jnet, be, jbe)
        es = be.stats()
        assert es["backups"] == 1 and es["backup_wins"] == 1 and es["executed"] == 1
        assert 0 <= recs[0].t_complete < 1.0 and recs[0].reuse is None

    def test_window_dedupe_rides_leader_future(self):
        pairs = _engine_nets(window=0.02, exec_time=0.1)
        base = normalize(np.ones(16, np.float32))
        rng = np.random.default_rng(5)
        r = rng.standard_normal(16).astype(np.float32)
        perp = normalize(r - (r @ base) * base)
        other = 0.8 * base + 0.6 * perp
        recs = []
        for net, _ in pairs:
            recs.append((net.submit_task("u1", "svc", base, 0.6, at_time=0.0),
                         net.submit_task("u2", "svc", other, 0.6, at_time=0.001)))
            net.run()
        (net, be), (jnet, jbe) = pairs
        _same(net, jnet, be, jbe)
        r1, r2 = recs[0]
        assert net.edge_nodes[net.en_nodes[0]].stats["window_reuse"] == 1
        assert be.stats()["executed"] == 1
        assert r2.reuse == "en" and r2.similarity == pytest.approx(0.8, abs=1e-5)
        assert r2.t_complete >= r1.t_complete - 0.02 and r2.t_complete >= 0.1

    def test_reuse_retains_completion_gap_under_queueing(self):
        net, _ = _drive(_engine_nets(window=0.008), _stream(150, noise=0.03), 0.004)
        m = net.metrics
        scratch = m.mean_completion(kind=(None,))
        reuse = m.mean_completion(kind=("en", "cs", "user"))
        assert np.isfinite(scratch) and np.isfinite(reuse)
        assert scratch / reuse >= 2.0


# -------------------------------------------------------- BENCH_cosim.json
def _bench_run(port, kind, load_hz, window_s, replicas, n_tasks=400, seed=0):
    """benchmarks/cosim.py::_run_one on either package."""
    params = (LSHParams if port else J.LSHParams)(dim=64, num_tables=5, num_probes=8,
                                                   seed=11)
    g, ens = (_testbed if port else jtestbed)()
    be = None
    if kind == "engine":
        be = (EngineBackend if port else JEngineBackend)(
            n_replicas=replicas, max_batch=16,
            max_wait_s=max(0.004, min(0.02, 8.0 / load_hz)),
            backup=(BackupPolicy if port else JBackup)(factor=3.0, max_backups=1), seed=5)
    net = (ReservoirNetwork if port else J.ReservoirNetwork)(
        g, ens, params, seed=seed, en_batch_window_s=window_s, backend=be,
        **({"device": "cpu"} if port else {}))
    spec = (DATASETS if port else JDATASETS)["stanford_ar"]
    net.register_service((dataset_service if port else jdataset_service)(spec))
    for u in range(4):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(DATASETS["stanford_ar"], n_tasks, seed=seed + 1)
    arrivals = np.cumsum(np.random.default_rng(seed + 2).exponential(1.0 / load_hz, n_tasks))
    for i, (t, x) in enumerate(zip(arrivals, X)):
        net.submit_task(f"u{i % 4}", spec.name, x, 0.9, at_time=float(t))
    net.run()
    m = net.metrics
    done = m.completed()
    assert len(done) == n_tasks
    scratch = m.mean_completion(kind=(None,))
    reuse = m.mean_completion(kind=("cs", "user", "en"))
    instant = float(np.mean([r.completion_time for r in done
                             if r.reuse is not None and not r.aggregated]))
    p99 = float(np.percentile([r.completion_time for r in done], 99)) * 1e3
    if be is not None:
        es = be.stats()
        stats = {k: es.get(k, 0) for k in ("executed", "aggregated", "backups",
                                           "backup_wins")}
    else:
        stats = {"executed": sum(en.stats["executed"] for en in net.edge_nodes.values())}
    derived = (f"gap_instant={scratch / instant:.2f}x;gap_all={scratch / reuse:.2f}x;"
               f"reuse_pct={m.reuse_fraction() * 100:.1f};ct_reuse_ms={reuse * 1e3:.2f};"
               f"p99_ms={p99:.1f};" + ";".join(f"{k}={v}" for k, v in stats.items()))
    return round(scratch * 1e6, 2), derived, [_key(r) for r in m.records]


BENCH = {r["name"]: r for r in json.loads((ROOT / "BENCH_cosim.json").read_text())["rows"]}


@pytest.mark.parametrize("kind,load,window,replicas", [
    ("inline", 50.0, 0.0, 0), ("engine", 50.0, 0.008, 2),
    ("engine", 200.0, 0.0, 2), ("engine", 200.0, 0.024, 4)])
def test_bench_cosim_row(kind, load, window, replicas):
    name = f"cosim/{kind}/load{load:.0f}/win{window * 1e3:.0f}ms"
    name += f"/rep{replicas}" if kind == "engine" else ""
    us, derived, records = _bench_run(True, kind, load, window, replicas)
    assert (us, derived) == (BENCH[name]["us_per_call"], BENCH[name]["derived"])
    assert (us, derived, records) == _bench_run(False, kind, load, window, replicas)


# ---------------------------------------------------------------- launcher
def test_serve_main_cosim_trace(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    serve_main(["--engine", "cosim", "--requests", "40", "--rate", "500",
                "--trace-out", str(trace)], device="cpu")
    out = capsys.readouterr().out
    assert "40 tasks through the co-sim" in out
    assert "phases: forward=" in out and "network reuse:" in out
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e["name"] == "task" and e["ph"] == "X"]
    assert len(spans) == 40
    assert sorted(e["tid"] for e in spans) == list(range(40))
    assert all(e["args"]["outcome"] for e in spans)


def test_build_cosim_every_task_completes():
    """``build_cosim`` (what ``--engine cosim`` runs) on the reduced model:
    every task completes, and the records by reuse kind (user, cs, en,
    executed) add up to the tasks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_cosim
    from repro_torch.models import build_model

    model = build_model(get_arch("qwen3-1.7b").reduced(), "cpu", seed=0)
    X, _ = make_stream(DATASETS["cctv1"], 40, seed=0)
    net, backend = build_cosim(model, X, rate=500.0, device="cpu")
    assert all(r.t_complete < 0 for r in net.metrics.records)
    net.run()
    recs = net.metrics.records
    assert all(r.t_complete >= 0 for r in recs)
    kinds = {k: sum(r.reuse == k for r in recs) for k in ("user", "cs", "en", None)}
    assert sum(kinds.values()) == 40 and kinds[None] > 0
    assert backend.stats()["executed"] > 0
    assert net.device.type == "cpu" and model.device.type == "cpu"
