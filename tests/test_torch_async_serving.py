"""The port's async serving stack against the JAX package's, on the CPU.

Mirrors of tests/test_async_serving.py (``TestEventLoop`` lives in
test_torch_sim_clock.py), of tests/test_serving.py::TestFleet and
::TestBatcher and of tests/test_training.py::TestElastic, run on the port
with ``device="cpu"``.  Cross-package: the async benchmark's two straggler
configurations (benchmarks/async_serving.py) go through both packages'
``AsyncServingEngine``; stats, makespan and every future's (reuse, replica,
backup) must be equal, latencies within 1e-9, and the virtual-clock fields
equal to the ``BENCH_async_serving.json`` rows.  Also the 520-request
async/sync parity trace through both packages.
"""
import numpy as np
import pytest
import torch

from repro.core.lsh import LSHParams as JParams
from repro.serving import AsyncServingEngine as JAsync
from repro.serving import ReplicaEngine as JReplica
from repro.serving import ServeRequest as JRequest
from repro.training.elastic import BackupPolicy as JBackup
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore
from repro_torch.serving import (
    AsyncServingEngine,
    Batcher,
    ReplicaEngine,
    ServeRequest,
    ServingFleet,
)
from repro_torch.training import (
    BackupPolicy,
    HealthTracker,
    choose_mesh_shape,
    plan_rescale,
)

CPU = "cpu"
KW = dict(dim=32, num_tables=3, num_probes=6, seed=5)
P = LSHParams(**KW)


def _vecs(n, seed=0, d=32):
    return normalize(np.random.default_rng(seed).standard_normal((n, d)))


def _execute(reqs):
    return [f"r{r.request_id}" for r in reqs]


def _replica(i, execute=_execute, params=P):
    return ReplicaEngine(i, params, execute, device=CPU)


def _engine(replicas, **kw):
    return AsyncServingEngine(P, replicas, device=CPU, **kw)


def _clustered_trace(n, n_clusters=20, seed=3, noise=0.04, request=ServeRequest):
    rng = np.random.default_rng(seed)
    base = _vecs(n_clusters, seed=seed + 1)
    embs = normalize(base[rng.integers(0, n_clusters, n)]
                     + noise * rng.standard_normal((n, 32)) / np.sqrt(32))
    return [request(i, "svc", embs[i], threshold=0.9) for i in range(n)]


# ------------------------------------------------------------------ batcher
class TestBatcherDeadlines:
    def test_per_replica_keys_are_independent(self):
        b = Batcher(max_batch=2, max_wait_s=1.0)
        r = ServeRequest(0, "svc", _vecs(1)[0])
        assert b.add(r, 0.0, key=(0, "svc")) is None
        assert b.add(r, 0.0, key=(1, "svc")) is None
        out = b.add(r, 0.0, key=(0, "svc"))
        assert out is not None and len(out) == 2
        assert b.pending((0, "svc")) == 0 and b.pending((1, "svc")) == 1

    def test_due_at_head_wait(self):
        b = Batcher(max_batch=8, max_wait_s=0.005)
        b.add(ServeRequest(0, "svc", _vecs(1)[0]), 1.0)
        assert b.due_at("svc") == pytest.approx(1.005)
        assert b.due_at("missing") is None

    def test_deadline_inheritance_tightens_flush(self):
        b = Batcher(max_batch=8, max_wait_s=0.1)
        b.add(ServeRequest(0, "svc", _vecs(1)[0]), 0.0)
        assert b.due_at("svc") == pytest.approx(0.1)
        b.add(ServeRequest(1, "svc", _vecs(1)[0], deadline_s=0.06), 0.02)
        assert b.due_at("svc") == pytest.approx(0.02)
        assert b.due("svc", 0.02) and not b.due("svc", 0.019)

    def test_deadline_leaves_half_budget(self):
        b = Batcher(max_batch=8, max_wait_s=0.005)
        b.add(ServeRequest(0, "svc", _vecs(1)[0], deadline_s=0.2), 1.0)
        assert b.due_at("svc") == pytest.approx(1.005)
        b2 = Batcher(max_batch=8, max_wait_s=0.08)
        b2.add(ServeRequest(0, "svc", _vecs(1)[0], deadline_s=0.2), 1.0)
        assert b2.due_at("svc") == pytest.approx(1.02)

    def test_flush_due_uses_keys(self):
        b = Batcher(max_batch=8, max_wait_s=0.005)
        b.add(ServeRequest(0, "svc", _vecs(1)[0]), 0.0, key=(2, "svc"))
        out = b.flush_due(0.02)
        assert list(out) == [(2, "svc")] and len(out[(2, "svc")]) == 1


class TestBatcher:
    def test_size_trigger(self):
        b = Batcher(max_batch=3, max_wait_s=1.0)
        out = None
        for i in range(3):
            out = b.add(ServeRequest(i, "svc", _vecs(1, seed=i)[0]), now=0.0)
        assert out is not None and len(out) == 3
        assert b.flushes == 1 and b.batched_total == 3

    def test_time_trigger(self):
        b = Batcher(max_batch=10, max_wait_s=0.01)
        b.add(ServeRequest(0, "svc", _vecs(1)[0]), now=0.0)
        assert not b.due("svc", 0.005)
        assert b.due("svc", 0.02)
        assert len(b.flush_due(0.02)["svc"]) == 1

    def test_deadline_pressure(self):
        b = Batcher(max_batch=10, max_wait_s=10.0)
        b.add(ServeRequest(0, "svc", _vecs(1)[0], deadline_s=0.02), now=0.0)
        assert b.due("svc", 0.015)


# ------------------------------------------------------- async/sync parity
class TestAsyncSyncParity:
    @staticmethod
    def _run_pair(n=520, window=16, replicas=2):
        trace = _clustered_trace(n)
        sync_fleet = ServingFleet(P, [_replica(i) for i in range(replicas)], device=CPU)
        async_eng = _engine([_replica(i) for i in range(replicas)],
                            backup=BackupPolicy(max_backups=0),
                            max_batch=window + 1, max_wait_s=0.001,
                            exec_time_fn=lambda rid, svc, reqs: 0.0)
        sync_out, async_out = [], []
        for lo in range(0, n, window):
            chunk = trace[lo:lo + window]
            sync_out.extend(sync_fleet.submit_batch_sync(chunk))
            futs = [async_eng.submit(r) for r in chunk]
            async_eng.drain()
            async_out.extend(f.result for f in futs)
        return sync_fleet, async_eng, sync_out, async_out

    def test_trace_parity_hits_similarities_stats(self):
        sync_fleet, async_eng, sync_out, async_out = self._run_pair()
        assert len(sync_out) == len(async_out) == 520
        for s, a in zip(sync_out, async_out):
            assert (s.request_id, s.reuse, s.result, s.replica) == (
                a.request_id, a.reuse, a.result, a.replica)
            assert abs(s.similarity - a.similarity) < 1e-5
        for rs, ra in zip(sync_fleet.replicas, async_eng.replicas):
            assert rs.stats == ra.stats
            assert set(rs.stores) == set(ra.stores)
            for svc in rs.stores:
                assert rs.stores[svc].live_ids() == ra.stores[svc].live_ids()

    def test_every_kind_exercised(self):
        _, async_eng, _, async_out = self._run_pair()
        assert {r.reuse for r in async_out} == {None, "cs", "en"}
        s = async_eng.stats()
        assert s["aggregated"] > 0
        assert s["cs"] + s["en"] + s["executed"] + s["aggregated"] == 520

    def test_async_trace_matches_reference(self):
        """The same chunked trace through the JAX package's async engine:
        every result, similarity (within SIM_TOL) and counter agrees."""
        _, async_eng, _, async_out = self._run_pair()
        jp = JParams(**KW)
        jeng = JAsync(jp, [JReplica(i, jp, _execute) for i in range(2)],
                      backup=JBackup(max_backups=0), max_batch=17, max_wait_s=0.001,
                      exec_time_fn=lambda rid, svc, reqs: 0.0)
        jtrace = _clustered_trace(520, request=JRequest)
        jout = []
        for lo in range(0, 520, 16):
            futs = [jeng.submit(r) for r in jtrace[lo:lo + 16]]
            jeng.drain()
            jout.extend(f.result for f in futs)
        for a, b in zip(jout, async_out):
            assert (a.request_id, a.reuse, a.result, a.replica, a.latency_s) == (
                b.request_id, b.reuse, b.result, b.replica, b.latency_s)
            assert abs(a.similarity - b.similarity) < 1e-4
        assert jeng.stats() == async_eng.stats()


# ------------------------------------------------ the async benchmark, both
BENCH_DIM, BENCH_N, BENCH_DEADLINE_S, BENCH_BASE_EXEC_S = 32, 600, 0.25, 0.08
# BENCH_async_serving.json rows async_serving/load{load}/batch{batch}/strag0.1
BENCH_WANT = {
    (200.0, 8): {"makespan_s": 3.12, "p99_ms": 244.4, "deadline_miss_pct": 1.0,
                 "backups": 19, "backup_wins": 7, "executed": 37, "en": 12, "cs": 519,
                 "aggregated": 32},
    (1000.0, 32): {"makespan_s": 2.39, "p99_ms": 593.2, "deadline_miss_pct": 2.8,
                   "backups": 35, "backup_wins": 24, "executed": 42, "en": 7, "cs": 364,
                   "aggregated": 187},
}


def _bench_run(pkg, load, max_batch):
    """benchmarks/async_serving.py's sweep at straggler rate 0.1 (its _trace,
    _exec_time_fn(0.1, seed=2), warm _replicas, arrivals from seed 3) through
    one package: (engine, futures, makespan)."""
    params_cls, replica_cls, request_cls, engine_cls, backup_cls, kw = pkg
    rng = np.random.default_rng(0)
    base = normalize(rng.standard_normal((24, BENCH_DIM)).astype(np.float32))
    embs = normalize(base[rng.integers(0, 24, BENCH_N)]
                     + 0.04 * rng.standard_normal((BENCH_N, BENCH_DIM)).astype(np.float32)
                     / np.sqrt(BENCH_DIM))
    reqs = [request_cls(i, "svc", embs[i], threshold=0.9, deadline_s=BENCH_DEADLINE_S)
            for i in range(BENCH_N)]
    exec_rng = np.random.default_rng(2)

    def exec_time(rid, service, batch):
        per_req = BENCH_BASE_EXEC_S * (1 + 0.2 * exec_rng.random())
        if exec_rng.random() < 0.1:
            per_req *= 8.0
        return per_req * max(1.0, len(batch)) ** 0.5

    def execute(batch):
        return [round(float(np.sum(np.asarray(r.embedding))), 5) for r in batch]

    params = params_cls(dim=BENCH_DIM, num_tables=5, num_probes=8, seed=7)
    replicas = [replica_cls(i, params, execute, **kw) for i in range(3)]
    for r in replicas:
        r.ttc.observe("svc", BENCH_BASE_EXEC_S)
    eng = engine_cls(params, replicas, backup=backup_cls(factor=1.5, max_backups=1),
                     max_batch=max_batch,
                     max_wait_s=min(BENCH_DEADLINE_S / 4, max_batch / load),
                     exec_time_fn=exec_time, **kw)
    arrivals = np.cumsum(np.random.default_rng(3).exponential(1.0 / load, BENCH_N))
    futs = [eng.submit_at(t, r) for t, r in zip(arrivals, reqs)]
    return eng, futs, eng.drain()


JAX_PKG = (JParams, JReplica, JRequest, JAsync, JBackup, {})
PORT_PKG = (LSHParams, ReplicaEngine, ServeRequest, AsyncServingEngine, BackupPolicy,
            {"device": CPU})


class TestAsyncBenchmarkCrossPackage:
    @pytest.mark.parametrize("load,max_batch", sorted(BENCH_WANT))
    def test_virtual_clock_fields_equal(self, load, max_batch):
        jeng, jfuts, jspan = _bench_run(JAX_PKG, load, max_batch)
        teng, tfuts, tspan = _bench_run(PORT_PKG, load, max_batch)
        assert tspan == jspan
        assert teng.stats() == jeng.stats()
        for a, b in zip(jfuts, tfuts):
            ra, rb = a.result, b.result
            assert (ra.request_id, ra.reuse, ra.replica, ra.backup, ra.result) == (
                rb.request_id, rb.reuse, rb.replica, rb.backup, rb.result)
            assert abs(ra.latency_s - rb.latency_s) <= 1e-9
        lats = np.asarray([f.result.latency_s for f in tfuts])
        s = teng.stats()
        got = {"makespan_s": round(float(tspan), 2),
               "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 1),
               "deadline_miss_pct": round(float(np.mean(lats > BENCH_DEADLINE_S)) * 100, 1),
               **{k: s[k] for k in ("backups", "backup_wins", "executed", "en", "cs",
                                    "aggregated")}}
        assert got == BENCH_WANT[(load, max_batch)]
        assert teng.pending() == 0 and teng.backup.active() == 0


# ------------------------------------------------------------ async engine
class TestAsyncEngine:
    @staticmethod
    def _routed_to(eng, rid, seed0=100):
        for s in range(seed0, seed0 + 500):
            v = _vecs(1, seed=s)[0]
            if eng.router.route(v)[0] == rid:
                return v
        raise AssertionError("no embedding routed to replica")

    @staticmethod
    def _prime_ttc(eng, svc="svc", t=0.05):
        for r in eng.replicas:
            r.ttc.observe(svc, t)

    @staticmethod
    def _straggling(n, **kw):
        return _engine([_replica(i) for i in range(n)],
                       backup=BackupPolicy(factor=1.5, max_backups=1), max_wait_s=0.005,
                       exec_time_fn=lambda rid, svc, reqs: 10.0 if rid == 0 else 0.05, **kw)

    def test_device_must_match_replicas(self):
        on_card = _replica(1)
        on_card.device = torch.device("cuda")     # as a replica built on the card
        with pytest.raises(ValueError, match=r"replicas \[1\] are not on"):
            _engine([_replica(0), on_card])
        assert _engine([_replica(0)]).router.lsh.device.type == "cpu"

    def test_shared_empty_loop_is_kept(self):
        from repro_torch.core.sim_clock import EventLoop

        loop = EventLoop()
        assert _engine([_replica(0)], loop=loop).loop is loop

    def test_cs_hit_resolves_immediately(self):
        eng = _engine([_replica(0)], max_wait_s=0.005)
        v = _vecs(1, seed=42)[0]
        f1 = eng.submit(ServeRequest(0, "svc", v))
        eng.drain()
        f2 = eng.submit(ServeRequest(1, "svc", v))
        assert f2.done and f2.result.reuse == "cs"
        assert f2.result.latency_s == 0.0
        assert f1.result.latency_s >= 0.005

    def test_followers_attach_and_record_wait(self):
        calls = {"n": 0}

        def execute(reqs):
            calls["n"] += len(reqs)
            return [f"r{r.request_id}" for r in reqs]

        eng = _engine([_replica(0, execute)], max_wait_s=0.005,
                      exec_time_fn=lambda *a: 0.1)
        v = _vecs(1, seed=43)[0]
        f1 = eng.submit(ServeRequest(0, "svc", v))
        eng.drain(until=0.002)
        f2 = eng.submit(ServeRequest(1, "svc", v))
        eng.drain()
        assert calls["n"] == 1
        assert f1.result.reuse is None
        assert f2.result.reuse == "cs" and f2.result.similarity == 1.0
        assert f2.result.result == f1.result.result
        assert f2.result.agg_wait_s == pytest.approx(0.103)
        assert f2.result.latency_s == pytest.approx(0.103)
        assert eng.stats()["aggregated"] == 1

    def test_straggler_backup_first_result_wins(self):
        eng = self._straggling(3)
        self._prime_ttc(eng)
        v = self._routed_to(eng, 0)
        fut = eng.submit(ServeRequest(0, "svc", v, threshold=0.9))
        eng.drain()
        res = fut.result
        assert res.backup and res.replica != 0
        assert res.latency_s < 1.0
        s = eng.stats()
        assert s["backups"] == 1 and s["backup_wins"] == 1
        assert sum(len(st) for r in eng.replicas for st in r.stores.values()) == 1
        assert s["executed"] == 1
        assert eng.pending() == 0 and eng.backup.active() == 0

    def test_backup_resolves_future_exactly_once(self):
        eng = self._straggling(2)
        self._prime_ttc(eng)
        v = self._routed_to(eng, 0)
        fut = eng.submit(ServeRequest(0, "svc", v, threshold=0.9))
        resolutions = []
        fut.add_done_callback(lambda f: resolutions.append(f.resolved_at))
        eng.drain()
        assert len(resolutions) == 1
        assert eng.loop.now == pytest.approx(10.005)

    def test_backup_win_backfills_primary_cs(self):
        eng = self._straggling(2)
        self._prime_ttc(eng)
        v = self._routed_to(eng, 0)
        eng.submit(ServeRequest(0, "svc", v, threshold=0.9))
        eng.drain()
        f = eng.submit(ServeRequest(1, "svc", v, threshold=0.9))
        assert f.done and f.result.reuse == "cs" and f.result.replica == 0

    def test_fast_primary_cancels_backup_timer(self):
        eng = _engine([_replica(i) for i in range(2)],
                      backup=BackupPolicy(factor=1.5, max_backups=1), max_wait_s=0.005,
                      exec_time_fn=lambda rid, svc, reqs: 0.01)
        self._prime_ttc(eng)
        fut = eng.submit(ServeRequest(0, "svc", _vecs(1, seed=44)[0]))
        eng.drain()
        s = eng.stats()
        assert fut.result.reuse is None and not fut.result.backup
        assert s["backups"] == 0 and s["backup_wins"] == 0
        assert eng.backup.active() == 0

    def test_max_backups_zero_never_redispatches(self):
        eng = _engine([_replica(i) for i in range(2)], backup=BackupPolicy(max_backups=0),
                      max_wait_s=0.005, exec_time_fn=lambda rid, svc, reqs: 5.0)
        self._prime_ttc(eng)
        fut = eng.submit(ServeRequest(0, "svc", _vecs(1, seed=45)[0]))
        eng.drain()
        assert fut.result.latency_s == pytest.approx(5.005)
        assert eng.stats()["backups"] == 0

    def test_cold_ttc_arms_no_backup(self):
        eng = _engine([_replica(i) for i in range(2)],
                      backup=BackupPolicy(factor=1.5, max_backups=1),
                      max_wait_s=0.005, exec_time_fn=lambda rid, svc, reqs: 5.0)
        fut = eng.submit(ServeRequest(0, "svc", _vecs(1, seed=48)[0]))
        eng.drain()
        assert fut.result.latency_s == pytest.approx(5.005)
        assert eng.stats()["backups"] == 0 and eng.backup.active() == 0

    def test_backup_en_hit_counts_win_and_backfills(self):
        eng = self._straggling(2)
        self._prime_ttc(eng)
        v = self._routed_to(eng, 0)
        eng.replicas[1]._store("svc").insert(v, "cached-on-backup")
        fut = eng.submit(ServeRequest(0, "svc", v, threshold=0.9))
        eng.drain()
        res = fut.result
        assert res.backup and res.replica == 1 and res.reuse == "en"
        assert res.result == "cached-on-backup"
        s = eng.stats()
        assert s["backups"] == 1 and s["backup_wins"] == 1
        assert s["executed"] == 0
        f2 = eng.submit(ServeRequest(1, "svc", v, threshold=0.9))
        assert f2.done and f2.result.reuse == "cs" and f2.result.replica == 0

    def test_abort_all_rejects_leaders_and_followers(self):
        from repro_torch.core.edge_node import ExecAborted

        eng = _engine([_replica(0)], max_wait_s=0.005, exec_time_fn=lambda *a: 1.0)
        v = _vecs(1, seed=51)[0]
        f1 = eng.submit(ServeRequest(0, "svc", v))
        f2 = eng.submit(ServeRequest(1, "svc", v))          # follower
        f3 = eng.submit(ServeRequest(2, "svc", _vecs(1, seed=52)[0]))
        eng.drain(until=0.5)                                # f1 and f3 executing
        eng.abort_all()
        for f in (f1, f2, f3):
            assert isinstance(f.exception, ExecAborted)
        assert eng.pending() == 0
        eng.drain()                                         # late completion: ignored
        assert isinstance(f1.exception, ExecAborted)

    def test_load_reports_depth_and_ewma(self):
        eng = _engine([_replica(i) for i in range(2)], max_wait_s=0.005,
                      exec_time_fn=lambda *a: 0.2)
        assert eng.load() == (0.0, 0.085)                   # the TTC prior
        eng.submit(ServeRequest(0, "svc", _vecs(1, seed=53)[0]))
        assert eng.load()[0] == 1.0
        eng.drain()
        depth, ewma = eng.load()
        assert depth == 0.0 and 0.085 < ewma < 0.2


# --------------------------------------------------- sync facade + stages
class TestSyncFacade:
    def test_submit_is_async_drained(self):
        fleet = ServingFleet(P, [_replica(i) for i in range(2)], device=CPU)
        res = fleet.submit(ServeRequest(0, "svc", _vecs(1, seed=46)[0]))
        assert res.reuse is None
        assert fleet.engine.pending() == 0
        assert fleet.engine.loop.now > 0

    def test_mixed_apis_share_one_cs_clock(self):
        fleet = ServingFleet(P, [_replica(0)], device=CPU)
        v = _vecs(1, seed=49)[0]
        r1 = fleet.submit(ServeRequest(0, "svc", v))
        assert r1.reuse is None
        out = fleet.submit_batch_sync([ServeRequest(1, "svc", v)])
        assert out[0].reuse == "cs" and out[0].result == r1.result

    def test_submit_batch_keeps_order(self):
        fleet = ServingFleet(P, [_replica(i) for i in range(3)], device=CPU)
        reqs = _clustered_trace(40)
        out = fleet.submit_batch(reqs)
        assert [r.request_id for r in out] == list(range(40))
        assert fleet.engine.pending() == 0 and fleet.submit_batch([]) == []

    def test_stats_include_engine_counters(self):
        fleet = ServingFleet(P, [_replica(0)], device=CPU)
        fleet.submit(ServeRequest(0, "svc", _vecs(1, seed=50)[0]))
        s = fleet.stats()
        assert {"backups", "backup_wins", "dispatches",
                "executed", "cs", "en", "aggregated"} <= set(s)
        assert s["dispatches"] == 1

    def test_follower_latency_inherits_leader_completion(self):
        eng = _replica(0)
        v = _vecs(1, seed=47)[0]
        out = eng.handle_batch([ServeRequest(0, "svc", v), ServeRequest(1, "svc", v)])
        assert out[1].reuse == "cs" and out[1].similarity == 1.0
        assert out[1].latency_s == out[0].latency_s
        assert out[1].agg_wait_s == out[0].latency_s
        assert out[0].agg_wait_s == 0.0


class TestFleet:
    @staticmethod
    def _exec_counter():
        calls = {"n": 0}

        def execute(reqs):
            calls["n"] += len(reqs)
            return [f"result-{r.request_id}" for r in reqs]

        return execute, calls

    def test_fleet_end_to_end(self):
        execute, calls = self._exec_counter()
        fleet = ServingFleet(P, [_replica(i, execute) for i in range(2)], device=CPU)
        base = _vecs(1, seed=11)[0]
        rng = np.random.default_rng(0)
        for i in range(30):
            emb = normalize(base + 0.03 * rng.standard_normal(32) / np.sqrt(32))
            assert fleet.submit(ServeRequest(i, "svc", emb, threshold=0.9)) is not None
        s = fleet.stats()
        assert s["executed"] < 10 and calls["n"] == s["executed"]
        assert s["cs"] + s["en"] + s["executed"] == 30

    def test_backup_policy_triggers(self):
        execute, _ = self._exec_counter()
        fleet = ServingFleet(P, [_replica(i, execute) for i in range(3)], device=CPU)
        fleet.replicas[0].ttc.observe("svc", 0.1)
        assert fleet.maybe_backup(0.05, "svc", primary=0) is None
        backup = fleet.maybe_backup(0.5, "svc", primary=0)
        assert backup is not None and backup != 0


# ------------------------------------------------------- satellite: store
class TestInsertBatchScatter:
    @pytest.mark.parametrize("bucket_cap", [1, 2, 8])
    def test_bit_identical_to_scalar_loop(self, bucket_cap):
        a = ReuseStore(P, capacity=1024, bucket_cap=bucket_cap, device=CPU)
        b = ReuseStore(P, capacity=1024, bucket_cap=bucket_cap, device=CPU)
        X = _vecs(300, seed=6)
        for i, v in enumerate(X):
            a.insert(v, i)
        b.insert_batch(X, list(range(300)))
        assert (a._slots == b._slots).all()
        assert (a._fill == b._fill).all()
        assert (a._cursor == b._cursor).all()
        assert a.overflows == b.overflows
        assert list(a._lru) == list(b._lru)

    def test_chunked_equals_single_batch(self):
        a = ReuseStore(P, capacity=1024, bucket_cap=4, device=CPU)
        b = ReuseStore(P, capacity=1024, bucket_cap=4, device=CPU)
        X = _vecs(256, seed=7)
        a.insert_batch(X, list(range(256)))
        for lo in range(0, 256, 32):
            b.insert_batch(X[lo:lo + 32], list(range(lo, lo + 32)))
        assert (a._slots == b._slots).all() and a.overflows == b.overflows

    def test_eviction_keeps_invariants(self):
        store = ReuseStore(P, capacity=64, device=CPU)
        X = _vecs(200, seed=8)
        store.insert_batch(X[:50], list(range(50)))
        store.insert_batch(X[50:], list(range(50, 200)))
        assert len(store) == 64
        live = set(store.live_ids())
        assert set(store._slots[store._slots >= 0].tolist()) <= live
        assert ((store._slots >= 0).sum(axis=2) == store._fill).all()
        out = store.query_batch(X[-20:], -1.0)
        assert all(idx in live for _, _, idx in out if idx is not None)

    def test_evicting_batch_matches_scalar_exactly(self):
        a = ReuseStore(P, capacity=20, bucket_cap=4, device=CPU)
        b = ReuseStore(P, capacity=20, bucket_cap=4, device=CPU)
        pre, batch = _vecs(18, seed=30), _vecs(15, seed=31)
        for s in (a, b):
            s.insert_batch(pre, [("pre", i) for i in range(18)])
        for i, v in enumerate(batch):
            a.insert(v, ("new", i))
        b.insert_batch(batch, [("new", i) for i in range(15)])
        assert (a._slots == b._slots).all()
        assert (a._fill == b._fill).all() and (a._cursor == b._cursor).all()
        assert a.overflows == b.overflows and list(a._lru) == list(b._lru)
        qa = a.query_batch(_vecs(30, seed=32), -1.0)
        qb = b.query_batch(_vecs(30, seed=32), -1.0)
        assert qa == qb

    def test_batch_larger_than_capacity_falls_back(self):
        store = ReuseStore(P, capacity=16, device=CPU)
        X = _vecs(64, seed=9)
        ids = store.insert_batch(X, list(range(64)))
        assert len(ids) == 64 and len(store) == 16
        assert set(store._slots[store._slots >= 0].tolist()) <= set(store.live_ids())


class TestQueryPeek:
    def test_peek_mutates_nothing(self):
        store = ReuseStore(P, capacity=256, device=CPU)
        X = _vecs(100, seed=10)
        store.insert_batch(X, list(range(100)))
        lru0 = list(store._lru)
        q0, cc0 = store.queries, len(store.candidate_counts)
        out_peek = store.query_batch(X[:8], 0.5, peek=True)
        assert list(store._lru) == lru0
        assert store.queries == q0 and len(store.candidate_counts) == cc0
        out = store.query_batch(X[:8], 0.5)
        assert [(s, i) for _, s, i in out_peek] == [(s, i) for _, s, i in out]


# ------------------------------------------------------------ control plane
class TestElastic:
    def test_health_tracker_failure_and_straggler(self):
        ht = HealthTracker(timeout_s=10, straggler_factor=2.0)
        for host in ("h0", "h1", "h2", "h3"):
            ht.heartbeat(host, now=0.0, step_time=1.0)
        ht.heartbeat("h3", now=0.0, step_time=5.0)
        ht.heartbeat("h3", now=0.0, step_time=5.0)
        for host in ("h0", "h1", "h2"):
            ht.heartbeat(host, now=20.0, step_time=1.0)
        assert ht.failed(25.0) == ["h3"]
        assert ht.alive_hosts(25.0) == ["h0", "h1", "h2"]
        ht2 = HealthTracker(straggler_factor=2.0)
        for host, t in (("a", 1.0), ("b", 1.0), ("c", 3.5)):
            for _ in range(4):
                ht2.heartbeat(host, 0.0, t)
        assert ht2.stragglers() == ["c"]

    def test_choose_mesh_shape(self):
        assert choose_mesh_shape(512) == (2, 16, 16)
        assert choose_mesh_shape(256) == (16, 16)
        assert choose_mesh_shape(240) == (15, 16)
        with pytest.raises(ValueError):
            choose_mesh_shape(8)

    def test_plan_rescale_moves_boundary_ranges_only(self):
        from repro.training.elastic import plan_rescale as jplan

        plan = plan_rescale((16, 16), 240)
        assert plan.new_shape == (15, 16)
        assert plan.replicas_before == 16 and plan.replicas_after == 15
        assert 0 < len(plan.moved_ranges) <= 15
        assert plan.moved_ranges == jplan((16, 16), 240).moved_ranges

    def test_backup_policy(self):
        bp = BackupPolicy(factor=1.5, max_backups=1)
        assert not bp.should_backup(0.1, 0.1, 0)
        assert bp.should_backup(0.2, 0.1, 0)
        assert not bp.should_backup(0.2, 0.1, 1)
        assert bp.backup_delay_s(0.1) == pytest.approx(0.15)
        assert bp.backup_delay_s(0.1, backups_sent=1) is None
        fired = []
        bp.arm("k", lambda: fired.append(1))
        bp.arm("k", lambda: fired.append(2))
        assert bp.active() == 2 and bp.cancel("k") == 2 and fired == [1, 2]
        assert bp.active() == 0 and bp.cancel("k") == 0
