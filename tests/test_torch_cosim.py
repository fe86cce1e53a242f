"""The co-simulation (``EngineBackend`` behind ``ReservoirNetwork``) of the
port against the JAX package's, on the CPU.

* Mirrors of tests/test_cosim.py::TestEngineCosim on the port with
  ``device="cpu"``; each run also goes through the reference, and every task
  record and the engines' counters must be equal (virtual execution times:
  the clock does not depend on the host).
* Four rows of ``BENCH_cosim.json`` (the sweep of benchmarks/cosim.py,
  rebuilt here on both packages): every derived field equal to the JSON at
  its printed precision and to the reference's run.
* Mirrors of tests/test_cosim.py's local-only federation and zero-fault
  chaos goldens: the seeded 500-task trace with a ``local-only`` federator,
  or with a ``ChaosController`` on an empty plan, equals the plain trace
  record for record, its pinned summaries, and the reference's run.
* The launcher's ``--engine cosim --trace-out`` on the reduced model: every
  task completes, the records by reuse kind add up, and the trace holds one
  task span a task.  Its virtual durations are measured wall times, so
  nothing else of it can be compared with the reference.  With
  ``--offload-policy`` it prints the reference's ``federation[...]`` line.
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
from repro.faults import ChaosController as JChaos
from repro.faults import FaultPlan as JFaultPlan
from repro.serving import EngineBackend as JEngineBackend
from repro.training.elastic import BackupPolicy as JBackup
from repro_torch.core.edge_node import Service
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.network import ReservoirNetwork
from repro_torch.core.topology import line_topology
from repro_torch.core.topology import testbed_topology as _testbed
from repro_torch.data import DATASETS, dataset_service, make_stream
from repro_torch.faults import ChaosController, FaultPlan
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


# ----------------------------------------- federation and chaos goldens
def _trace(port, protocol, offload_policy=None, chaos=False, n_tasks=500):
    """tests/test_cosim.py::_trace (the testbed, ``stanford_ar``, 3 users, a
    task every 12 ms, forwarding errors measured) on either package, with a
    federator of ``offload_policy`` or a chaos controller on an empty plan."""
    params = (LSHParams if port else J.LSHParams)(dim=64, num_tables=5, num_probes=8)
    g, ens = (_testbed if port else jtestbed)()
    net = (ReservoirNetwork if port else J.ReservoirNetwork)(
        g, ens, params, seed=0, protocol=protocol, measure_fwd_errors=True,
        offload_policy=offload_policy, **({"device": "cpu"} if port else {}))
    if chaos:
        (ChaosController if port else JChaos)(net, (FaultPlan if port else JFaultPlan)())
    spec = (DATASETS if port else JDATASETS)["stanford_ar"]
    net.register_service((dataset_service if port else jdataset_service)(spec))
    for u in range(3):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(DATASETS["stanford_ar"], n_tasks, seed=7)
    for i, x in enumerate(X):
        net.submit_task(f"u{i % 3}", spec.name, x, 0.9, at_time=0.012 * i)
    net.run()
    return net


def _full_key(r):
    return (r.task_id, r.t_submit, r.t_complete, r.reuse, r.similarity, r.correct,
            r.forwarding_error, r.reuse_node, r.aggregated, r.result, r.remote_en,
            r.stale_owner)


# tests/test_cosim.py's pinned summaries of the 500-task trace
GOLDEN = {
    "direct": {"tasks": 500, "mean_ct_scratch": 0.11743256895503866,
               "mean_ct_cs": 0.006210639836999299, "mean_ct_en": 0.015915092919248766,
               "reuse_pct": 84.0, "reuse_pct_cs": 28.4, "reuse_pct_en": 55.60000000000001,
               "accuracy_pct": 100.0, "fwd_error_pct": 6.800000000000001},
    "ttc": {"tasks": 500, "mean_ct_scratch": 0.13539679846951094,
            "mean_ct_cs": 0.006334329121343468, "mean_ct_en": 0.015930518390692365,
            "reuse_pct": 86.6, "reuse_pct_cs": 28.000000000000004,
            "reuse_pct_en": 58.599999999999994, "accuracy_pct": 100.0, "fwd_error_pct": 6.0},
}


def _golden_parity(protocol, **kw):
    """The trace with ``kw`` on the port equals the plain trace on the port,
    the pinned summaries and the same trace on the reference."""
    plain, port, ref = (_trace(True, protocol), _trace(True, protocol, **kw),
                        _trace(False, protocol, **kw))
    assert [_full_key(r) for r in port.metrics.records] == \
        [_full_key(r) for r in plain.metrics.records]
    assert [_full_key(r) for r in port.metrics.records] == \
        [_full_key(r) for r in ref.metrics.records]
    assert port.metrics.summary() == plain.metrics.summary() == ref.metrics.summary()
    s = port.metrics.summary()
    for k, v in GOLDEN[protocol].items():
        assert s[k] == pytest.approx(v, rel=1e-9), k
    return port, ref


@pytest.mark.parametrize("protocol", ("direct", "ttc"))
def test_local_only_federation_bit_for_bit(protocol):
    """A local-only federator (gossip ticking, ``decide`` on every miss, no
    offload) changes nothing."""
    port, ref = _golden_parity(protocol, offload_policy="local-only")
    assert port.federator is not None and port.federator.stats["offloads"] == 0
    assert port.federator.stats["decisions"] > 0
    assert dict(port.federator.stats) == dict(ref.federator.stats)
    assert port.federator.gossip.rounds == ref.federator.gossip.rounds


@pytest.mark.parametrize("protocol", ("direct", "ttc"))
def test_zero_fault_chaos_bit_for_bit(protocol):
    """A chaos controller on an empty plan sits on every link traversal
    and draws nothing: the run is the plain one."""
    port, ref = _golden_parity(protocol, chaos=True)
    assert port.chaos is not None and port.chaos.plan.empty
    assert all(v == 0 for v in port.chaos.stats.values())
    assert dict(port.chaos.stats) == dict(ref.chaos.stats)


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


@pytest.mark.parametrize("policy", ["local-only", "least-loaded", "reuse-affinity"])
def test_serve_main_cosim_offload_policy(policy, capsys):
    """``--engine cosim --offload-policy`` runs the co-simulation with a
    federator between the two ENs and prints the reference's federation
    line; local-only never offloads."""
    serve_main(["--engine", "cosim", "--requests", "40", "--rate", "500",
                "--offload-policy", policy], device="cpu")
    out = capsys.readouterr().out
    assert "40 tasks through the co-sim" in out
    line = [x for x in out.splitlines() if x.strip().startswith("federation[")]
    assert len(line) == 1 and line[0].strip().startswith(f"federation[{policy}]: offloads=")
    fields = dict(kv.split("=") for kv in line[0].split(": ", 1)[1].split())
    assert set(fields) == {"offloads", "remote_hits", "remote_execs", "rebalances"}
    assert all(v.isdigit() for v in fields.values())
    if policy == "local-only":
        assert fields["offloads"] == "0"
    assert int(fields["remote_hits"]) + int(fields["remote_execs"]) <= int(fields["offloads"])


@pytest.mark.parametrize("policy", ["least-loaded", "reuse-affinity"])
def test_build_cosim_offloads_to_the_other_en(policy):
    """``build_cosim(..., offload_policy=...)`` on the reduced model, each
    execution charged 60 ms of virtual time (a B=1 prefill of the full-width
    model on the card takes about that; the reduced one's wall time would
    leave the queues empty): the ENs offload misses to each other, the other
    EN runs some of them on its own replicas, and every task completes."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_cosim
    from repro_torch.models import build_model

    model = build_model(get_arch("qwen3-1.7b").reduced(), "cpu", seed=0)
    X, _ = make_stream(DATASETS["cctv1"], 60, seed=0)
    net, backend = build_cosim(model, X, rate=200.0, offload_policy=policy, device="cpu")
    for engine in backend.engines.values():
        engine.exec_time_fn = lambda *_: 0.06
    net.run()
    fs = net.federator.stats
    assert all(r.t_complete >= 0 for r in net.metrics.records)
    assert fs["remote_execs"] > 0
    assert fs["offloads"] == fs["remote_hits"] + fs["remote_execs"] + fs["remote_coalesced"]
    assert sum(en.stats["offloaded"] for en in net.edge_nodes.values()) == fs["offloads"]
    assert sum(en.stats["remote_execs"] for en in net.edge_nodes.values()) == fs["remote_execs"]


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
