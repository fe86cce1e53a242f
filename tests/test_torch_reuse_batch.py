"""The port's batched reuse store against the JAX package's, on the CPU.

Mirrors of tests/test_reuse_batch.py ``TestBatchScalarParity``,
``TestEvictionConsistency`` and ``TestBucketOverflow``: the scalar
``query``, ``query_batch`` (the fused path from ``fused_min_batch`` = 64
queries on, the staged path below) and insert-at-capacity, which
``EdgeNode.handle_task_batch`` and the network's batch windows drive.  The
reference runs the same operations; where its batch would take its fused
Pallas path (which needs ``pl.load``, gone from this JAX) it runs its
staged path (``fused = False``), the fused path's oracle.  Hit/miss, ids
and results must be equal, similarities within 1e-5, and the slot tables
(``_slots``, ``_fill``) and live ids identical.
"""
import numpy as np
import pytest

import repro.core as J
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore

P = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)
JP = J.LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)


def _vecs(n, seed=0, d=32):
    return normalize(np.random.default_rng(seed).standard_normal((n, d)))


def _stores(capacity=256, **kw):
    """The port's store (fused path on) and the reference's staged one."""
    return (ReuseStore(P, capacity=capacity, device="cpu", **kw),
            J.ReuseStore(JP, capacity=capacity, fused=False, **kw))


def _filled(n=200, capacity=256, seed=1, **kw):
    stores = _stores(capacity, **kw)
    X = _vecs(n, seed=seed)
    for s in stores:
        s.insert_batch(X, [f"r{i}" for i in range(n)])
    return stores, X


def _same_hits(got, want, tol=1e-5):
    assert len(got) == len(want)
    for (rg, sg, ig), (rw, sw, iw) in zip(got, want):
        assert ig == iw and rg == rw
        assert abs(sg - sw) < tol


def _same_tables(port, ref):
    assert np.array_equal(port._slots, ref._slots)
    assert np.array_equal(port._fill, ref._fill)
    assert port.live_ids() == ref.live_ids()
    assert port.overflows == ref.overflows


def _queries(X, noise, seed=2):
    rng = np.random.default_rng(seed)
    return normalize(X + noise * rng.standard_normal(X.shape) / np.sqrt(X.shape[1]))


class TestBatchScalarParity:
    @pytest.mark.parametrize("noise", [0.02, 0.3, 1.5])
    def test_same_hits_and_similarities(self, noise):
        (store, ref), X = _filled(150)
        q = _queries(X[:64], noise)
        bat = store.query_batch(q, 0.9)
        assert store.last_query_fused            # 64 queries: the fused path
        _same_hits(bat, ref.query_batch(q, 0.9))
        scal = [store.query(v, 0.9) for v in q]
        _same_hits(scal, [ref.query(v, 0.9) for v in q])
        for (rs, ss, is_), (rb, sb, ib) in zip(scal, bat):
            assert (is_ is None) == (ib is None) and abs(ss - sb) < 1e-5
            if is_ is not None:
                assert is_ == ib and rs == rb
        assert store.live_ids() == ref.live_ids()   # LRU order after the hits

    def test_per_query_thresholds(self):
        (store, ref), X = _filled(100)
        q = _queries(X[:10], 0.25)
        thrs = np.linspace(0.0, 1.0, 10).astype(np.float32)
        bat = store.query_batch(q, thrs)
        _same_hits(bat, ref.query_batch(q, thrs))
        for t, v, (r, sim, idx) in zip(thrs, q, bat):
            rs, ss, is_ = store.query(v, float(t))
            assert (is_ is None) == (idx is None) and abs(ss - sim) < 1e-5

    def test_non_cosine_similarity_parity(self):
        store, ref = _stores(similarity="structural")
        X = _vecs(100, seed=21)
        for s in (store, ref):
            s.insert_batch(X, list(range(100)))
        q = _queries(X[:32], 0.1, seed=22)
        bat = store.query_batch(q, 0.95)
        _same_hits(bat, ref.query_batch(q, 0.95), tol=1e-6)
        for v, (r, sim, idx) in zip(q, bat):
            rs, ss, is_ = store.query(v, 0.95)
            assert (is_ is None) == (idx is None) and abs(ss - sim) < 1e-6

    def test_candidate_count_stats_parity(self):
        (store, ref), X = _filled(120)
        q = _queries(X[:16], 0.1, seed=23)
        for s in (store, ref):
            for v in q:
                s.query(v, 0.9)
            s.query_batch(q, 0.9)
        assert store.candidate_counts == ref.candidate_counts
        assert store.candidate_counts[-16:] == store.candidate_counts[-32:-16]

    def test_empty_store_all_miss(self):
        for s in _stores(capacity=16):
            assert s.query_batch(_vecs(5), 0.5) == [(None, -1.0, None)] * 5

    def test_batch_refreshes_lru(self):
        for s in _filled(20, capacity=32)[0]:
            oldest = s.live_ids()[0]
            s.query_batch(s.embedding_of(oldest)[None], 0.99)
            assert s.live_ids()[-1] == oldest


class TestEvictionConsistency:
    def test_evicted_slots_never_candidates(self):
        store, ref = _stores(capacity=16)
        X = normalize(np.random.default_rng(3).standard_normal((128, 32)))
        for i, v in enumerate(X):
            for s in (store, ref):
                s.insert(v, i)
            in_tables = set(store._slots[store._slots >= 0].tolist())
            assert in_tables <= set(store.live_ids())
            _same_tables(store, ref)
        assert len(store) == 16

    def test_evicted_never_returned_by_query_batch(self):
        store, ref = _stores(capacity=8)
        X = _vecs(64, seed=4)
        for s in (store, ref):
            s.insert_batch(X, list(range(64)))
        _same_tables(store, ref)
        live = set(store.live_ids())
        out = store.query_batch(X, -1.0)     # threshold -1: any candidate hits
        assert store.last_query_fused
        for r, sim, idx in out:
            assert idx is None or idx in live
        _same_hits(out, ref.query_batch(X, -1.0))

    def test_fill_counts_match_slots(self):
        store, ref = _stores(capacity=32)
        for i, v in enumerate(_vecs(100, seed=5)):
            for s in (store, ref):
                s.insert(v, i)
        assert ((store._slots >= 0).sum(axis=2) == store._fill).all()
        _same_tables(store, ref)


class TestBucketOverflow:
    def test_ring_overflow_keeps_store_consistent(self):
        store, ref = _stores(capacity=512, bucket_cap=2)
        X = _vecs(200, seed=6)
        for s in (store, ref):
            s.insert_batch(X, list(range(200)))
        assert store.overflows > 0 and (store._fill <= store.bucket_cap).all()
        _same_tables(store, ref)
        live = set(store.live_ids())
        out = store.query_batch(X[-50:], -1.0)
        assert all(idx in live for _, _, idx in out if idx is not None)
        assert sum(idx is not None for _, _, idx in out) == 50
        _same_hits(out, ref.query_batch(X[-50:], -1.0))

    def test_overflowed_eviction_is_silent(self):
        store, ref = _stores(capacity=512, bucket_cap=1)
        for i, v in enumerate(_vecs(120, seed=7)):
            for s in (store, ref):
                s.insert(v, i)
        for s in (store, ref):
            s.capacity = 4
            while len(s) > 4:
                s._evict_lru()
        assert (store._fill >= 0).all()
        assert set(store._slots[store._slots >= 0].tolist()) <= set(store.live_ids())
        _same_tables(store, ref)
