"""The port's serving engine and router against the JAX package's, on the CPU.

One seeded request stream (exact repeats, near-duplicates and fresh
requests, at batch 128 and batch 16) goes through a JAX ``ReplicaEngine``
whose stores run their staged path and through the port's.  Reuse kinds,
results, statistics and store contents must agree; similarities within
``SIM_TOL``.  Also: the router's owners and buckets, and ``convert.py``.
"""
import numpy as np
import pytest

from repro.core.lsh import LSH as JLSH
from repro.core.lsh import LSHParams as JParams
from repro.core.reuse_store import ReuseStore as JStore
from repro.serving.engine import ReplicaEngine as JEngine
from repro.serving.engine import ReuseRouter as JRouter
from repro.serving.engine import ServeRequest as JRequest
from repro_torch import convert
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.serving.engine import ReplicaEngine, ReuseRouter, ServeRequest

SIM_TOL = 1e-4
KW = dict(dim=32, num_tables=3, num_probes=6, seed=5)
CPU = "cpu"


def _execute(reqs):
    return [f"result-{r.request_id}" for r in reqs]


def _stream(rng, n_batches, size, pool):
    """Batches of (request id, embedding): a third exact repeats of earlier
    requests, a third near-duplicates, a third fresh."""
    rid = len(pool)
    for _ in range(n_batches):
        batch = []
        for _ in range(size):
            kind = rng.integers(0, 3) if pool else 2
            if kind == 0:
                emb = pool[rng.integers(0, len(pool))]
            elif kind == 1:
                src = pool[rng.integers(0, len(pool))]
                emb = normalize(src + 0.03 * rng.standard_normal(32).astype(np.float32)
                                / np.sqrt(32))
            else:
                emb = normalize(rng.standard_normal(32).astype(np.float32))
            pool.append(emb)
            batch.append((rid, emb))
            rid += 1
        yield batch


class TestEngineCrossPackage:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_request_stream_agrees(self, seed):
        rng = np.random.default_rng(seed)
        jeng = JEngine(0, JParams(**KW), _execute, store_capacity=2000)
        teng = ReplicaEngine(0, LSHParams(**KW), _execute, store_capacity=2000, device=CPU)
        jeng._store("svc").fused = False    # the JAX staged path runs here
        pool, t = [], 0.0
        batches = list(_stream(rng, 3, 128, pool)) + list(_stream(rng, 4, 16, pool))
        batches.append(next(_stream(rng, 1, 256, pool)))
        for batch in batches:
            thr = float(rng.choice([0.8, 0.9, 0.95]))
            jres = jeng.handle_batch([JRequest(i, "svc", e, threshold=thr) for i, e in batch],
                                     now=t)
            tres = teng.handle_batch([ServeRequest(i, "svc", e, threshold=thr)
                                      for i, e in batch], now=t)
            for a, b in zip(jres, tres):
                assert (a.request_id, a.reuse, a.result) == (b.request_id, b.reuse, b.result)
                assert abs(a.similarity - b.similarity) < SIM_TOL
            t += 1.0
        assert dict(jeng.stats) == dict(teng.stats)
        assert dict(teng.stats)["en"] > 0 and dict(teng.stats)["cs"] > 0
        js, ts = jeng.stores["svc"], teng.stores["svc"]
        assert js.live_ids() == ts.live_ids()
        assert js.candidate_counts == ts.candidate_counts
        assert ts.fused_queries > 0 and ts.staged_queries > 0
        assert jeng.ttc.informed("svc") and teng.ttc.informed("svc")

    def test_scalar_handle_agrees(self):
        rng = np.random.default_rng(3)
        jeng = JEngine(0, JParams(**KW), _execute)
        teng = ReplicaEngine(0, LSHParams(**KW), _execute, device=CPU)
        pool = []
        for batch in _stream(rng, 1, 24, pool):
            for i, e in batch:
                a = jeng.handle(JRequest(i, "svc", e, threshold=0.9), now=0.0)
                b = teng.handle(ServeRequest(i, "svc", e, threshold=0.9), now=0.0)
                assert (a.reuse, a.result) == (b.reuse, b.result)
                assert abs(a.similarity - b.similarity) < SIM_TOL
        assert dict(jeng.stats) == dict(teng.stats)


class TestRouterCrossPackage:
    @pytest.mark.parametrize("n,bucket_range", [(4, None), (3, (10, 200))])
    def test_route_batch_owners_and_buckets(self, n, bucket_range):
        x = normalize(np.random.default_rng(4).standard_normal((200, 32)))
        jr = JRouter(JParams(**KW), n, bucket_range=bucket_range)
        tr = ReuseRouter(LSHParams(**KW), n, bucket_range=bucket_range, device=CPU)
        jo, jb = jr.route_batch(x)
        to, tb = tr.route_batch(x)
        assert np.array_equal(np.asarray(jb), tb) and np.array_equal(jo, to)
        for v in x[:10]:
            (a, ab), (b, bb) = jr.route(v), tr.route(v)
            assert a == b and np.array_equal(np.asarray(ab), bb)
        jr.rescale(2)
        tr.rescale(2)
        assert np.array_equal(jr.route_batch(x)[0], tr.route_batch(x)[0])


class TestConvert:
    @pytest.mark.parametrize("family", ["cross_polytope", "hyperplane"])
    def test_lsh_from_arrays(self, family):
        kw = dict(KW, family=family, seed=12)
        j = JLSH(JParams(**kw))
        # a different seed in the port's params: the arrays decide
        t = convert.lsh_from_arrays(
            LSHParams(**dict(kw, seed=99)),
            rotations=None if j.rotations is None else np.asarray(j.rotations),
            planes=None if j.planes is None else np.asarray(j.planes), device=CPU)
        x = normalize(np.random.default_rng(5).standard_normal((30, 32)))
        assert np.array_equal(np.asarray(j.hash_batch(x)), t.hash_batch(x).numpy())
        assert np.array_equal(np.asarray(j.probe_batch(x)), t.probe_batch(x).numpy())
        with pytest.raises(ValueError):
            convert.lsh_from_arrays(LSHParams(**kw), device=CPU,
                                    rotations=np.zeros((1, 1, 2, 2), np.float32))

    def test_store_export_round_trip(self):
        rng = np.random.default_rng(6)
        js = JStore(JParams(**KW), capacity=500, fused=False, use_kernel_threshold=1)
        x = normalize(rng.standard_normal((300, 32)).astype(np.float32))
        js.insert_batch(x, [f"r{i}" for i in range(300)])
        ids = js.live_ids()[50:250]
        exp = js.export(ids)
        ts = convert.store_from_export(LSHParams(**KW), exp.ids, exp.embeddings, exp.results,
                                       exp.buckets, capacity=500, device=CPU)
        assert len(ts) == 200
        for k, i in enumerate(ids[:20]):
            assert np.array_equal(ts.buckets_of(ts.live_ids()[k]), js.buckets_of(i))
        fresh = JStore(JParams(**KW), capacity=500, fused=False, use_kernel_threshold=1)
        fresh.insert_batch(exp.embeddings, exp.results, buckets=exp.buckets)
        q = normalize(x[40:140] + 0.03 * rng.standard_normal((100, 32)).astype(np.float32)
                      / np.sqrt(32))
        for a, b in zip(fresh.query_batch(q, 0.9, peek=True), ts.query_batch(q, 0.9, peek=True)):
            assert a[0] == b[0] and a[2] == b[2] and abs(a[1] - b[1]) < SIM_TOL
