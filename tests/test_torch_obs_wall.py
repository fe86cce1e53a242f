"""The port's span recorder on the host's wall clock (``obs/trace.py``):
nesting, arming, the garbage collector's spans, the Chrome export, the
serving path's spans, and the virtual-clock recorder left as it was.  No
JAX: the port alone, on the CPU."""
import gc
import json

import numpy as np
import pytest
import torch

from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.sim_clock import EventLoop
from repro_torch.obs import Tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import (AsyncServingEngine, ReplicaEngine, ServeRequest,
                                 ServingFleet)

CPU = "cpu"
P = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)
# every span the sync serving path records, once a batch
SERVING = {"fleet.submit", "router.route", "replica.handle", "replica.name", "replica.cs",
           "store.query", "store.sync", "store.dispatch", "store.read", "store.results",
           "replica.exec", "replica.commit", "store.insert", "store.evict"}


@pytest.fixture(autouse=True)
def disarmed():
    obs_trace.disarm_wall()
    yield
    obs_trace.disarm_wall()


def _names(tr):
    return {s[2] for s in tr.spans}


def _fleet(capacity=150, n_fill=400, seed=0):
    """Two replicas whose stores are at capacity (inserts evict) and whose
    batches of 100 take the fused query."""
    x = normalize(np.random.default_rng(seed).standard_normal((n_fill + 200, 32)))
    reps = [ReplicaEngine(i, P, lambda reqs: [f"r{r.request_id}" for r in reqs],
                          cs_capacity=64, store_capacity=capacity, device=CPU)
            for i in range(2)]
    fleet = ServingFleet(P, reps, device=CPU)
    owners, _ = fleet.router.route_batch(x[:n_fill])
    for i, rep in enumerate(reps):
        mine = np.nonzero(owners == i)[0]
        rep._store("svc").insert_batch(x[mine], [f"f{k}" for k in mine])
    reqs = [ServeRequest(k, "svc", x[n_fill + k], threshold=0.99) for k in range(200)]
    return fleet, reqs


class TestNesting:
    def test_spans_nest_with_their_parents(self):
        tr = Tracer.wall()
        with tr.span("a", k=1) as a:
            with tr.span("b") as b:
                with tr.span("c"):
                    pass
            with tr.span("d") as d:
                d.note(n=2)
        got = {name: (sid, parent, t0, t1, args) for sid, parent, name, t0, t1, args in tr.spans}
        assert [s[2] for s in tr.spans] == ["c", "b", "d", "a"]   # in the order they end
        assert got["a"][1] == 0 and got["b"][1] == a.sid and got["d"][1] == a.sid
        assert got["c"][1] == b.sid
        assert got["a"][4] == {"k": 1} and got["d"][4] == {"n": 2} and got["b"][4] is None
        for name, (_, parent, t0, t1, _) in got.items():
            assert isinstance(t0, int) and isinstance(t1, int) and t0 <= t1
            if parent:
                p = next(v for v in got.values() if v[0] == parent)
                assert p[2] <= t0 and t1 <= p[3]
        assert tr.open_spans() == []

    def test_an_exception_closes_the_span(self):
        tr = Tracer.wall()
        with pytest.raises(ValueError):
            with tr.span("outer"):
                with tr.span("inner"):
                    raise ValueError
        assert [s[2] for s in tr.spans] == ["inner", "outer"] and tr.open_spans() == []

    def test_open_spans_lists_the_nested_ones(self):
        tr = Tracer.wall()
        with tr.span("a") as a:
            assert tr.open_spans() == [(a.sid, "a", "span", 0)]


class TestArming:
    def test_disarmed_records_nothing(self):
        assert obs_trace.span("x") is obs_trace.NOOP and not obs_trace.NOOP
        with obs_trace.span("x") as sp:
            assert sp is obs_trace.NOOP
            sp.note(k=1)
        fleet, reqs = _fleet()
        last = obs_trace.wall()
        before = len(last.spans) if last is not None else 0
        fleet.submit_batch_sync(reqs)
        assert obs_trace.wall() is last
        assert (len(last.spans) if last is not None else 0) == before

    def test_arm_and_disarm(self):
        tr = obs_trace.arm_wall()
        assert obs_trace.arm_wall() is tr and obs_trace.wall() is tr
        with obs_trace.span("x") as sp:
            assert sp and sp is not obs_trace.NOOP
        assert obs_trace.disarm_wall() is tr
        assert obs_trace.span("y") is obs_trace.NOOP
        assert obs_trace.wall() is tr and [s[2] for s in tr.spans if s[2] != "gc"] == ["x"]
        assert obs_trace.disarm_wall() is None

    def test_follows_the_torch_profiler(self):
        fleet, reqs = _fleet()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fleet.submit_batch_sync(reqs[:100])
            tr = obs_trace.wall()
            assert tr is not None and obs_trace.span("x") is not obs_trace.NOOP
        assert "fleet.submit" in _names(tr)
        fleet.submit_batch_sync(reqs[100:])          # the profiler has stopped
        assert obs_trace.span("x") is obs_trace.NOOP
        assert sum(s[2] == "fleet.submit" for s in tr.spans) == 1

    def test_an_armed_recorder_outlasts_the_profiler(self):
        tr = obs_trace.arm_wall()
        fleet, reqs = _fleet()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fleet.submit_batch_sync(reqs[:100])
        fleet.submit_batch_sync(reqs[100:])
        assert obs_trace.wall() is tr and sum(s[2] == "fleet.submit" for s in tr.spans) == 2


class TestGarbageCollector:
    def test_gc_spans_only_while_armed(self):
        tr = obs_trace.arm_wall()
        with obs_trace.span("work") as sp:
            gc.collect()
        gcs = [s for s in tr.spans if s[2] == "gc"]
        assert gcs and any(s[1] == sp.sid for s in gcs)
        assert all(s[5]["generation"] in (0, 1, 2) for s in gcs)
        obs_trace.disarm_wall()
        n = len(tr.spans)
        gc.collect()
        assert len(tr.spans) == n and tr._on_gc not in gc.callbacks


class TestExport:
    def test_chrome_export_of_wall_spans(self, tmp_path):
        tr = Tracer.wall()
        with tr.span("outer", tasks=3):
            with tr.span("inner"):
                pass
        path = tmp_path / "wall.json"
        doc = tr.export(str(path))
        assert json.loads(path.read_text()) == doc
        xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
        outer, inner = xs["outer"], xs["inner"]
        assert outer["args"]["tasks"] == 3 and inner["args"]["parent"] == outer["args"]["id"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        t0 = next(s[3] for s in tr.spans if s[2] == "outer")
        assert outer["ts"] == pytest.approx(t0 / 1e3, abs=1e-3)        # µs, under 1 ns lost
        names = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
        assert "spans" in names and doc["displayTimeUnit"] == "ms"


class TestServingPath:
    def test_a_submission_records_its_layers_and_closes_them(self):
        fleet, reqs = _fleet()
        tr = obs_trace.arm_wall()
        out = fleet.submit_batch_sync(reqs)
        assert all(r is not None for r in out) and tr.open_spans() == []
        assert SERVING <= _names(tr)
        by_id = {s[0]: s for s in tr.spans}
        (root,) = [s for s in tr.spans if s[2] == "fleet.submit"]
        assert root[1] == 0 and root[5] == {"tasks": 200}
        parent = {s[2]: by_id[s[1]][2] for s in tr.spans if s[1] and s[2] != "gc"}
        assert parent["router.route"] == parent["replica.handle"] == "fleet.submit"
        assert parent["store.query"] == "replica.handle" and parent["store.read"] == "store.query"
        assert parent["store.evict"] == "store.insert"
        assert parent["store.insert"] == "replica.commit"
        handles = [s for s in tr.spans if s[2] == "replica.handle"]
        assert sorted(s[5]["replica"] for s in handles) == [0, 1]
        assert sum(s[5]["tasks"] for s in handles) == 200
        queries = [s[5] for s in tr.spans if s[2] == "store.query"]
        assert all(q["fused"] and q["queries"] > 0 and q["pairs"] > 0 for q in queries)
        syncs = [s[5] for s in tr.spans if s[2] == "store.sync"]
        assert all(set(a) == {"pages", "slabs", "bytes"} for a in syncs)
        assert sum(a["bytes"] for a in syncs) > 0
        evicts = [s[5]["tasks"] for s in tr.spans if s[2] == "store.evict"]
        assert sum(evicts) == sum(r.reuse is None for r in out)
        # three sites touch the Content Store: lookups, EN-hit admissions, inserts
        assert sum(s[2] == "replica.cs" for s in tr.spans) == 3 * len(handles)

    def test_armed_and_disarmed_answers_are_the_same(self):
        plain_fleet, reqs = _fleet()
        plain = plain_fleet.submit_batch_sync(reqs)
        obs_trace.arm_wall()
        armed_fleet, reqs = _fleet()
        armed = armed_fleet.submit_batch_sync(reqs)
        key = [(r.result, r.reuse, r.similarity, r.replica) for r in plain]
        assert key == [(r.result, r.reuse, r.similarity, r.replica) for r in armed]


class TestVirtualClock:
    def test_virtual_events_with_the_wall_recorder_armed(self):
        """The loop's tracer keeps virtual time while the wall recorder
        records the same run (tests/test_torch_sim_clock.py's dispatch case)."""
        wall = obs_trace.arm_wall()
        eng = AsyncServingEngine(P, [ReplicaEngine(0, P, lambda reqs: [0] * len(reqs),
                                                   device=CPU)],
                                 loop=EventLoop(trace=True), device=CPU)
        eng.submit(ServeRequest(0, "svc", normalize(np.ones(32)), trace_tid=11))
        eng.drain()
        evs = [e for e in eng.loop.tracer.events if e["name"] == "engine-dispatch"]
        assert [(e["tid"], e["args"]["task"], e["ph"]) for e in evs] == [(11, 11, "i")]
        assert evs[0]["ts"] == pytest.approx(0.005e6)
        assert eng.loop.tracer.spans == [] and "store.query" in _names(wall)

    def test_virtual_span_reads_the_loop(self):
        loop = EventLoop(trace=True)
        loop.call_later(2.0, lambda: None)
        loop.run()
        tr = loop.tracer
        with tr.span("at-two"):
            pass
        (s,) = tr.spans
        assert s[3] == s[4] == 2.0
        x = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "X"]
        assert x[0]["ts"] == 2.0e6 and x[0]["dur"] == 0
