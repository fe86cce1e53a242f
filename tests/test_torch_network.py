"""The port's network simulator against the JAX package's, on the CPU.

* The seeded 500-task acceptance trace of tests/test_cosim.py (``direct``
  and ``ttc``) reproduces the pinned ``GOLDEN`` summaries at rel=1e-9, and
  every task record equals the reference ``ReservoirNetwork``'s on the same
  trace (the port's CPU stores score with numpy, as the reference does, so
  the equality is exact); so does the 250-task windowed trace.
* ``icedge`` mode, ``paper_topology`` and ``line_topology`` runs equal the
  reference's record by record.
* Mirrors of tests/test_reuse_batch.py ``TestEdgeNodeBatch`` and
  ``TestNetworkBatchWindow``.
* ``add_en`` before any task moves no entry and creates no federator, as
  the reference's join does (federation itself:
  tests/test_torch_{federation,migration,faults}.py).
* Device plumbing: every store the simulator creates lives on the network's
  device, and without a card the entry points refuse to run unless given
  ``device="cpu"``.
"""
import json

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.edge_node import EdgeNode as JEdgeNode
from repro.core.edge_node import Service as JService
from repro.core.topology import line_topology as jline
from repro.core.topology import paper_topology as jpaper
from repro.core.topology import testbed_topology as jtestbed
from repro.data import DATASETS as JDATASETS
from repro.data import dataset_service as jdataset_service
from repro_torch.core.edge_node import EdgeNode, Service
from repro_torch.core.lsh import LSHParams, get_lsh, normalize
from repro_torch.core.namespace import make_task_name
from repro_torch.core.network import ReservoirNetwork
from repro_torch.core.packets import Interest
from repro_torch.core.topology import line_topology, paper_topology
from repro_torch.core.topology import testbed_topology as _testbed
from repro_torch.data import DATASETS, dataset_service, make_stream

# tests/test_cosim.py's pinned summaries of the seeded 500-task trace
GOLDEN = {
    "direct": {
        "tasks": 500,
        "mean_ct_scratch": 0.11743256895503866,
        "mean_ct_cs": 0.006210639836999299,
        "mean_ct_en": 0.015915092919248766,
        "reuse_pct": 84.0,
        "reuse_pct_cs": 28.4,
        "reuse_pct_en": 55.60000000000001,
        "accuracy_pct": 100.0,
        "fwd_error_pct": 6.800000000000001,
    },
    "ttc": {
        "tasks": 500,
        "mean_ct_scratch": 0.13539679846951094,
        "mean_ct_cs": 0.006334329121343468,
        "mean_ct_en": 0.015930518390692365,
        "reuse_pct": 86.6,
        "reuse_pct_cs": 28.000000000000004,
        "reuse_pct_en": 58.599999999999994,
        "accuracy_pct": 100.0,
        "fwd_error_pct": 6.0,
    },
}


def _golden_trace(port, protocol, window, n_tasks=500, mode="reservoir", **kw):
    """tests/test_cosim.py::_trace on either package: the testbed, the
    ``stanford_ar`` service, 3 users, a task every 12 ms, threshold 0.9,
    forwarding errors measured, seed 0."""
    params = (LSHParams if port else J.LSHParams)(dim=64, num_tables=5, num_probes=8)
    g, ens = (_testbed if port else jtestbed)()
    net = (ReservoirNetwork if port else J.ReservoirNetwork)(
        g, ens, params, seed=0, protocol=protocol, en_batch_window_s=window,
        measure_fwd_errors=True, mode=mode, **kw, **({"device": "cpu"} if port else {}))
    spec = (DATASETS if port else JDATASETS)["stanford_ar"]
    net.register_service((dataset_service if port else jdataset_service)(spec))
    for u in range(3):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(DATASETS["stanford_ar"], n_tasks, seed=7)
    t = 0.0
    for i, x in enumerate(X):
        net.submit_task(f"u{i % 3}", spec.name, x, 0.9, at_time=t)
        t += 0.012
    net.run()
    return net


def _key(r):
    return (r.task_id, r.name, r.t_submit, r.t_complete, r.reuse, r.similarity, r.correct,
            r.forwarding_error, r.reuse_node, r.aggregated, r.result, r.retx, r.failed)


def _summary(net):
    return {k: None if v != v else v for k, v in net.metrics.summary().items()}


def _same(port, ref):
    assert len(port.metrics.records) == len(ref.metrics.records)
    for a, b in zip(port.metrics.records, ref.metrics.records):
        assert _key(a) == _key(b)
    assert _summary(port) == _summary(ref)
    for node in ref.edge_nodes:
        assert dict(port.edge_nodes[node].stats) == dict(ref.edge_nodes[node].stats)
    for node in ref.forwarders:
        assert vars(port.forwarders[node].stats) == vars(ref.forwarders[node].stats)


class TestGoldenTraces:
    @pytest.mark.parametrize("protocol", ["direct", "ttc"])
    def test_golden_500_tasks(self, protocol):
        port = _golden_trace(True, protocol, 0.0)
        s = port.metrics.summary()
        for k, v in GOLDEN[protocol].items():
            assert s[k] == pytest.approx(v, rel=1e-9), k
        ref = _golden_trace(False, protocol, 0.0)
        _same(port, ref)
        assert port.metrics.summary() == ref.metrics.summary()
        # the registry's phase decomposition too (NaN: no window follower)
        nan_none = lambda d: {k: None if v != v else v for k, v in d.items()}  # noqa: E731
        assert (nan_none(port.registry.phase_summary())
                == nan_none(ref.registry.phase_summary()))

    @pytest.mark.parametrize("protocol", ["direct", "ttc"])
    def test_batch_window_250_tasks(self, protocol):
        port = _golden_trace(True, protocol, 0.024, n_tasks=250)
        ref = _golden_trace(False, protocol, 0.024, n_tasks=250)
        _same(port, ref)
        assert port.metrics.summary() == ref.metrics.summary()
        assert sum(en.stats["window_reuse"] for en in port.edge_nodes.values()) > 0

    def test_icedge(self):
        port = _golden_trace(True, "direct", 0.0, n_tasks=200, mode="icedge")
        _same(port, _golden_trace(False, "direct", 0.0, n_tasks=200, mode="icedge"))
        assert port.metrics.reuse_fraction("en") > 0

    def test_traced_run_is_the_same_run(self, tmp_path):
        """An armed tracer observes only: records equal the untraced
        reference's, and the export holds one task span per task."""
        port = _golden_trace(True, "ttc", 0.024, n_tasks=100, trace=True)
        _same(port, _golden_trace(False, "ttc", 0.024, n_tasks=100))
        path = tmp_path / "trace.json"
        port.loop.tracer.export(str(path))
        spans = [e for e in json.loads(path.read_text())["traceEvents"]
                 if e["name"] == "task" and e["ph"] == "X"]
        assert len(spans) == 100 and not port.loop.tracer.open_spans()


def _topology_pair(make_port, make_ref, users, n=150, seed=3, dim=32):
    nets = []
    rng = np.random.default_rng(seed)
    base = normalize(rng.standard_normal((10, dim)).astype(np.float32))
    X = normalize(base[rng.integers(0, 10, n)]
                  + 0.05 * rng.standard_normal((n, dim)).astype(np.float32) / np.sqrt(dim))
    for port in (True, False):
        g, ens = (make_port if port else make_ref)()
        params = (LSHParams if port else J.LSHParams)(dim=dim, num_tables=5, num_probes=8)
        net = (ReservoirNetwork if port else J.ReservoirNetwork)(
            g, ens, params, seed=seed, measure_fwd_errors=True,
            **({"device": "cpu"} if port else {}))
        net.register_service((Service if port else JService)(
            "/svc", execute=lambda x: round(float(np.sum(x)), 4), input_dim=dim))
        for u, node in enumerate(users(g, ens)):
            net.add_user(f"u{u}", node)
        t = 0.0
        for i, x in enumerate(X):
            net.submit_task(f"u{i % len(net.users)}", "svc", x, 0.9, at_time=t)
            t += 0.01
        net.run()
        nets.append(net)
    _same(*nets)
    return nets[0]


class TestTopologies:
    def test_paper_topology(self):
        """An AS-like 20-40 node graph with 10 ENs (§V-C), users at
        non-EN nodes."""
        net = _topology_pair(
            lambda: paper_topology(seed=4), lambda: jpaper(seed=4),
            lambda g, ens: [n for n in sorted(g.nodes) if n not in ens][:4])
        assert len(net.en_nodes) == 10
        assert all(r.t_complete >= 0 for r in net.metrics.records)
        assert net.metrics.reuse_fraction() > 0.3

    def test_line_topology(self):
        net = _topology_pair(lambda: line_topology(3), lambda: jline(3),
                             lambda g, ens: [0, 0])
        assert all(r.t_complete >= 0 for r in net.metrics.records)


# ------------------------------------------- tests/test_reuse_batch.py mirrors
P = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)
JP = J.LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)


def _vecs(n, seed=0, d=32):
    return normalize(np.random.default_rng(seed).standard_normal((n, d)))


class TestEdgeNodeBatch:
    def _ens(self):
        out = []
        for E, S, params, kw in ((EdgeNode, Service, P, {"device": "cpu"}),
                                 (JEdgeNode, JService, JP, {})):
            en = E("/en/test", params, store_capacity=256, **kw)
            en.register(S("/svc", execute=lambda x: round(float(np.sum(x)), 4),
                          exec_time_s=0.05, input_dim=32))
            out.append(en)
        return out

    def _task(self, v, thr=0.9, I=Interest):
        buckets = get_lsh(P, "cpu").hash_one(normalize(v))
        return I(make_task_name("/svc", buckets, P.index_size_bytes),
                 app_params={"input": normalize(v), "threshold": thr})

    @staticmethod
    def _outs(outs):
        return [(o.data.name, o.data.content, o.data.meta, o.reused, o.similarity,
                 o.exec_time_s, o.store_size) for o in outs]

    def test_batch_executes_then_reuses(self):
        got = []
        X = _vecs(16, seed=8)
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            out1 = en.handle_task_batch([self._task(v, I=I) for v in X])
            out2 = en.handle_task_batch([self._task(v, I=I) for v in X])
            got.append((self._outs(out1), self._outs(out2)))
        assert got[0] == got[1]
        out1, out2 = got[0]
        assert not any(o[3] for o in out1)
        assert all(o[3] and o[5] == 0.0 for o in out2)
        assert [o[1] for o in out1] == [o[1] for o in out2]

    def test_batch_matches_scalar_handling(self):
        X = _vecs(24, seed=9)
        rng = np.random.default_rng(10)
        q = normalize(X[:12] + 0.02 * rng.standard_normal((12, 32)) / np.sqrt(32))
        got = []
        scalar_ens, batch_ens = self._ens(), self._ens()   # (port, reference) each
        for en_s, en_b, I in zip(scalar_ens, batch_ens, (Interest, J.Interest)):
            for v in X[:12]:
                en_s.handle_task(self._task(v, I=I))
            en_b.handle_task_batch([self._task(v, I=I) for v in X[:12]])
            outs_s = [en_s.handle_task(self._task(v, I=I)) for v in q]
            outs_b = en_b.handle_task_batch([self._task(v, I=I) for v in q])
            for a, b in zip(outs_s, outs_b):
                assert a.reused == b.reused
                if a.reused:
                    assert abs(a.similarity - b.similarity) < 1e-5
            got.append((self._outs(outs_s), self._outs(outs_b)))
        assert got[0] == got[1]
        assert any(o[3] for o in got[0][1])

    def test_unknown_service_raises(self):
        for en, I in zip(self._ens(), (Interest, J.Interest)):
            with pytest.raises(KeyError):
                en.handle_task_batch([I("/other/task/00", app_params={"input": _vecs(1)[0]})])


class TestNetworkBatchWindow:
    def _run(self, window, port=True, n=120, threshold=0.9):
        g, ens = (_testbed if port else jtestbed)()
        net = (ReservoirNetwork if port else J.ReservoirNetwork)(
            g, ens, P if port else JP, seed=0, en_batch_window_s=window,
            cs_capacity=0, user_cs_capacity=0, **({"device": "cpu"} if port else {}))
        net.register_service((Service if port else JService)(
            "/svc", execute=lambda x: float(np.sum(x) > 0), exec_time_s=(0.07, 0.1),
            input_dim=32))
        net.add_user("u1", "fwd1")
        net.add_user("u2", "fwd2")
        rng = np.random.default_rng(11)
        base = _vecs(12, seed=12)
        t = 0.0
        for i in range(n):
            x = normalize(base[i % 12] + 0.05 * rng.standard_normal(32) / np.sqrt(32))
            net.submit_task("u1" if i % 2 else "u2", "/svc", x, threshold, at_time=t)
            t += 0.01
        net.run()
        return net

    @pytest.mark.parametrize("window", [0.0, 0.02])
    def test_equal_to_reference(self, window):
        port = self._run(window)
        _same(port, self._run(window, port=False))
        assert all(r.t_complete >= 0 for r in port.metrics.records)

    def test_en_reuse_happens_under_window(self):
        assert self._run(window=0.02).metrics.reuse_fraction("en") > 0.3

    def test_window_comparable_to_scalar(self):
        scalar, batched = self._run(window=0.0), self._run(window=0.02)
        rs, rb = (n.metrics.reuse_fraction("en") for n in (scalar, batched))
        assert abs(rs - rb) < 0.35
        assert batched.metrics.accuracy() > 0.9


# ---------------------------------------------------------------- federation
class TestFederationNotPorted:
    def test_join_with_nothing_to_move_is_the_reference_join(self):
        """``add_en`` before any task: a re-partition that moves no entry
        (no federator), equal to the reference's, and the new EN's stores
        live on the network's device."""
        nets = []
        for port in (True, False):
            g, ens = (_testbed if port else jtestbed)()
            net = (ReservoirNetwork if port else J.ReservoirNetwork)(
                g, ens, (P if port else JP), seed=0,
                **({"device": "cpu"} if port else {}))
            net.register_service((Service if port else JService)(
                "/svc", execute=lambda x: round(float(np.sum(x)), 4), input_dim=32))
            net.add_en("en3", attach_to="fwd2")
            net.add_user("u1", "fwd1")
            for i, x in enumerate(_vecs(60, seed=20)):
                net.submit_task("u1", "svc", x, 0.9, at_time=0.01 * i)
            net.run()
            nets.append(net)
        _same(*nets)
        port = nets[0]
        assert port.federator is None
        assert port.edge_nodes["en3"].stores["svc"].device.type == "cpu"
        assert port.edge_nodes["en3"].stats["executed"] > 0


# ------------------------------------------------------------------- devices
class TestDevices:
    def test_every_store_on_the_network_device(self):
        from repro_torch.serving import EngineBackend

        g, ens = _testbed()
        be = EngineBackend(n_replicas=2)
        net = ReservoirNetwork(g, ens, P, backend=be, device="cpu")
        net.register_service(Service("/svc", execute=lambda x: 0, input_dim=32))
        net.add_en("en3", attach_to="fwd2")
        assert net.device.type == "cpu" and net.lsh.device.type == "cpu"
        for en in net.edge_nodes.values():
            assert en.device.type == "cpu"
            assert all(s.device.type == "cpu" for s in en.stores.values())
        assert set(be.engines) == {"en1", "en2", "en3"}
        for engine in be.engines.values():
            assert engine.router.lsh.device.type == "cpu"
            assert all(r.device.type == "cpu" for r in engine.replicas)

    def test_entry_points_default_to_cuda(self):
        from repro_torch.device import resolve_device
        from repro_torch.serving import EngineBackend

        if torch.cuda.is_available():
            assert resolve_device(None).type == "cuda"
            return

        g, ens = _testbed()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReservoirNetwork(g, ens, P)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ReservoirNetwork(g, ens, P, backend=EngineBackend())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EdgeNode("/en/x", P)
