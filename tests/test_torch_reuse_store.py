"""The port's ReuseStore against the JAX package's, on the CPU.

One seeded op sequence goes into a JAX store on its staged path
(``fused=False``, which ``tests/test_fused_query.py::TestParity`` pins as
bit-equal to its fused path) and into the port's store with ``fused=True``
and ``fused=False``.  Results, ids, LRU order, candidate statistics and sync
counters must agree; similarities within ``SIM_TOL``.  The port-only classes
mirror the reference's store tests (tests/test_fused_query.py,
tests/test_reuse_batch.py::TestPagedResidency).
"""
import numpy as np
import pytest

from repro.core.lsh import LSHParams as JParams
from repro.core.reuse_store import ReuseStore as JStore
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore
from repro_torch.kernels import fused_query as tfused
from repro_torch.kernels import ops

SIM_TOL = 1e-4
KW = dict(dim=16, num_tables=3, num_probes=4, num_buckets=64, seed=3)
PARAMS = LSHParams(**KW)
CPU = "cpu"


def _vecs(rng, n, d=16):
    return normalize(rng.standard_normal((n, d)).astype(np.float32))


def _near(rng, x, noise=0.05):
    return normalize(x + noise * rng.standard_normal(x.shape).astype(np.float32)
                     / np.sqrt(x.shape[1]))


class TestCrossPackageSequence:
    def _stores(self):
        common = dict(capacity=400, page_size=8, use_kernel_threshold=1)
        return (JStore(JParams(**KW), fused=False, **common),
                ReuseStore(PARAMS, fused=True, device=CPU, **common),
                ReuseStore(PARAMS, fused=False, device=CPU, **common))

    @staticmethod
    def _same(outs):
        ref = outs[0]
        for other in outs[1:]:
            assert len(other) == len(ref)
            for i, ((ra, sa, ia), (rb, sb, ib)) in enumerate(zip(ref, other)):
                assert ia == ib, i
                assert ra == rb, i
                assert abs(sa - sb) < SIM_TOL, i

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_op_sequence_agrees(self, seed):
        rng = np.random.default_rng(seed)
        stores = self._stores()
        jst, tf, ts = stores
        tag = iter(range(10 ** 6))

        def insert(x):
            res = [f"r{next(tag)}" for _ in range(len(x))]
            ids = [s.insert_batch(x, res) for s in stores]
            assert ids[0] == ids[1] == ids[2]

        def query(x, peek=False):
            thr = rng.choice([0.0, 0.5, 0.9], len(x)).astype(np.float32)
            self._same([s.query_batch(x, thr, peek=peek) for s in stores])

        base = _vecs(rng, 150)
        insert(base)                                  # growth past many pages
        assert jst.num_pages == tf.num_pages > 1
        query(np.concatenate([_near(rng, base[:48]), _vecs(rng, 48)]))   # fused
        assert tf.last_query_fused and not ts.last_query_fused
        query(_near(rng, base[50:70]))                # B < 64: staged everywhere
        assert not tf.last_query_fused
        query(_near(rng, base[:80]), peek=True)
        for v in _near(rng, base[100:104]):           # scalar path
            self._same([[s.query(v, 0.5)] for s in stores])
        for idx in rng.choice(jst.live_ids(), 10, replace=False):
            for s in stores:
                s.remove(int(idx))
        insert(_vecs(rng, 30))                        # reuses the freed slots
        moved = [int(i) for i in rng.choice(jst.live_ids(), 25, replace=False)]
        exps = [s.extract(moved) for s in stores]
        for s, e in zip(stores, exps):
            np.testing.assert_array_equal(e.buckets, exps[0].buckets)
            s.insert_batch(e.embeddings, e.results, buckets=e.buckets)
        query(np.concatenate([_near(rng, exps[0].embeddings), _vecs(rng, 45)]))
        query(_near(rng, exps[0].embeddings[:10]))
        insert(_vecs(rng, 300))                       # past capacity: evictions
        query(np.concatenate([_near(rng, base[:50]), _vecs(rng, 50)]))
        query(_vecs(rng, 12))

        for s in stores[1:]:
            assert s.live_ids() == jst.live_ids()
            assert s.candidate_counts == jst.candidate_counts
            assert (s.inserts, s.queries, s.overflows) == (jst.inserts, jst.queries,
                                                           jst.overflows)
        for name in ("sync_pages_total", "sync_bytes_total", "last_sync_pages",
                     "table_sync_pages_total", "last_table_sync_pages",
                     "fused_queries", "staged_queries"):
            assert getattr(ts, name) == getattr(jst, name), name
        assert tf.fused_queries == 96 + 70 + 100 and tf.table_sync_pages_total > 0
        assert tf.staged_queries == jst.staged_queries - tf.fused_queries


def _pair(n=300, seed=7, **kw):
    """Identically filled (staged, fused) port stores."""
    rng = np.random.default_rng(seed)
    a = ReuseStore(PARAMS, capacity=1000, page_size=8, fused=False, device=CPU, **kw)
    b = ReuseStore(PARAMS, capacity=1000, page_size=8, fused=True,
                   fused_min_batch=1, use_kernel_threshold=1, device=CPU, **kw)
    x = _vecs(rng, n)
    a.insert_batch(x, [f"r{i}" for i in range(n)])
    b.insert_batch(x, [f"r{i}" for i in range(n)])
    return a, b, x


class TestOneDispatch:
    def test_one_kernel_call_per_fused_query(self, monkeypatch):
        _, b, x = _pair()
        b.query_batch(x[:32], 0.5)      # materialize both mirrors
        b.sync_device()

        def boom(*a, **k):
            raise AssertionError("staged path invoked on the fused hot path")

        b._query_staged = boom
        b._candidate_matrix = boom
        calls = []
        real = tfused.reuse_top1_probed
        monkeypatch.setattr(tfused, "reuse_top1_probed",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        d0 = ops.FUSED_DISPATCH_COUNT
        for _ in range(3):
            b.query_batch(x[:32], 0.5)
        assert ops.FUSED_DISPATCH_COUNT - d0 == 3 and len(calls) == 3
        assert b.last_sync_pages == 0 and b.last_table_sync_pages == 0

    def test_batch_padding_keeps_results(self):
        _, b, x = _pair()
        full = b.query_batch(x[:24], 0.5, peek=True)
        for n in (17, 18, 23):
            assert b.query_batch(x[:n], 0.5, peek=True) == full[:n]


class TestTableMirrorSync:
    def test_first_sync_uploads_all_then_o_dirty(self):
        _, b, x = _pair(n=200)
        b.query_batch(x[:32], 0.5)
        assert b.table_sync_pages_total >= -(-b._table_rows // b._table_slab_rows)
        before = b.table_sync_pages_total
        b.insert(_vecs(np.random.default_rng(1), 1)[0], "x")
        b.query_batch(x[:32], 0.5)
        assert 1 <= b.table_sync_pages_total - before <= PARAMS.num_tables
        b.query_batch(x[:32], 0.5)
        assert b.last_table_sync_pages == 0

    def test_sync_device_drains_table_dirt_off_query_path(self):
        _, b, x = _pair(n=200)
        b.query_batch(x[:32], 0.5)
        b.insert(_vecs(np.random.default_rng(2), 1)[0], "x")
        assert b._tdirty and b._dirty
        b.sync_device()
        assert not b._tdirty and not b._dirty
        b.query_batch(x[:32], 0.5)
        assert b.last_table_sync_pages == 0 and b.last_sync_pages == 0

    def test_remove_dirties_tables_and_fused_forgets_entry(self):
        _, b, x = _pair(n=100)
        [hit] = b.query_batch(x[10][None], 0.99)
        assert hit[2] is not None
        b.remove(hit[2])
        assert b._tdirty
        [out] = b.query_batch(x[10][None], 0.99)
        assert out[2] != hit[2]

    def test_mirror_matches_host_tables_after_churn(self):
        _, b, x = _pair(n=150)
        b.query_batch(x[:32], 0.5)
        for k in (2, 30, 70):
            b.remove(b.live_ids()[k])
        b.insert_batch(_vecs(np.random.default_rng(3), 20), list(range(20)))
        b.query_batch(x[:32], 0.5)
        flat = b._slots.reshape(b._table_rows, b.bucket_cap)
        assert (b._slots_dev.numpy() == flat).all()
        b.audit_mirror()


class TestRouting:
    def test_small_batches_and_non_cosine_stay_staged(self):
        store = ReuseStore(PARAMS, capacity=100, page_size=8, device=CPU)
        assert not store._use_fused(4) and store._use_fused(4096)
        struct = ReuseStore(PARAMS, capacity=100, similarity="structural", fused=True,
                            fused_min_batch=1, use_kernel_threshold=1, device=CPU)
        assert not struct._use_fused(4096)
        off = ReuseStore(PARAMS, capacity=100, fused=False, device=CPU)
        assert not off._use_fused(1 << 20)

    def test_work_threshold_gate(self):
        store = ReuseStore(PARAMS, capacity=100, fused=True, fused_min_batch=1,
                           use_kernel_threshold=1 << 30, device=CPU)
        assert not store._use_fused(64)

    def test_page_size_rounds_to_multiple_of_8(self):
        for ps, want in ((1, 8), (4, 8), (8, 8), (12, 16), (4096, 4096)):
            assert ReuseStore(PARAMS, capacity=10, page_size=ps, device=CPU).page_size == want
        with pytest.raises(ValueError):
            ReuseStore(PARAMS, capacity=10, page_size=0, device=CPU)


class TestPagedResidency:
    """Mirror of tests/test_reuse_batch.py::TestPagedResidency on the port."""

    P = LSHParams(dim=32, num_tables=3, num_probes=6, seed=5)

    def _store(self, page_size=8, **kw):
        return ReuseStore(self.P, capacity=4096, page_size=page_size, device=CPU, **kw)

    @staticmethod
    def _v(n, seed):
        return normalize(np.random.default_rng(seed).standard_normal((n, 32)))

    def test_insert_batch_dirties_only_touched_pages(self):
        store = self._store()
        store.insert_batch(self._v(20, 30), list(range(20)))
        store.sync_device(ensure=True)
        assert store.last_sync_pages == 3
        store.insert_batch(self._v(6, 31), list(range(20, 26)))
        assert store.sync_device() == 2
        store.insert(self._v(1, 32)[0], 26)
        assert store.sync_device() == 1
        assert store.sync_device() == 0

    def test_growth_appends_pages_without_copy(self):
        store = self._store()
        store.insert_batch(self._v(8, 33), list(range(8)))
        page0 = store._pages[0]
        store.insert_batch(self._v(40, 34), list(range(8, 48)))
        assert store._pages[0] is page0 and store.num_pages == 6

    def test_device_growth_uploads_only_new_pages(self):
        store = self._store()
        store.insert_batch(self._v(16, 35), list(range(16)))
        store.sync_device(ensure=True)
        assert store.device_pages == 2
        total0 = store.sync_pages_total
        store.insert_batch(self._v(24, 36), list(range(16, 40)))
        assert store.sync_device() == 3
        assert store.device_pages == 8 and store.sync_pages_total == total0 + 3
        np.testing.assert_array_equal(store._emb_dev.numpy()[:5], np.stack(store._pages))

    def test_query_batch_parity_across_page_sizes(self):
        x = self._v(120, 37)
        q = normalize(x[:32] + 0.1 * np.random.default_rng(38).standard_normal((32, 32))
                      / np.sqrt(32))
        outs = []
        for ps in (4, 16, 4096):
            store = self._store(page_size=ps, use_kernel_threshold=1)
            store.insert_batch(x, list(range(120)))
            outs.append(store.query_batch(q, 0.9))
        for other in outs[1:]:
            for (ra, sa, ia), (rb, sb, ib) in zip(outs[0], other):
                assert ia == ib and ra == rb and abs(sa - sb) < 1e-6

    def test_full_resync_knob_reuploads_everything(self):
        store = self._store(full_resync=True)
        store.insert_batch(self._v(40, 39), list(range(40)))
        store.sync_device(ensure=True)
        assert store.last_sync_pages == 5
        store.insert(self._v(1, 40)[0], 40)
        assert store.sync_device() == 6
        assert store.sync_device() == 0


class TestTombstone:
    """Mirror of tests/test_store_properties.py::TestTombstone on the port."""

    P = LSHParams(dim=32, num_tables=3, num_probes=6, num_buckets=64, seed=5)

    def test_remove_zeroes_row_and_dirties_page(self):
        store = ReuseStore(self.P, capacity=64, page_size=8, device=CPU)
        idx = store.insert(_vecs(np.random.default_rng(0), 1, 32)[0], "r")
        store.sync_device(ensure=True)
        assert store.last_sync_pages == 1
        store.remove(idx)
        assert not store.embedding_of(idx).any()
        assert idx // store.page_size in store._dirty
        store.sync_device()
        assert not store._emb_dev[idx // store.page_size, idx % store.page_size].any()

    def test_eviction_tombstones_like_remove(self):
        store = ReuseStore(self.P, capacity=4, page_size=4, device=CPU)
        for i, v in enumerate(_vecs(np.random.default_rng(1), 12, 32)):
            store.insert(v, i)
        live = set(store.live_ids())
        for idx in range(store._n_slots):
            if idx not in live:
                assert not store.embedding_of(idx).any(), idx

    @pytest.mark.parametrize("fused", [False, True])
    def test_reused_slot_serves_new_embedding_through_kernel(self, fused):
        store = ReuseStore(self.P, capacity=64, page_size=8, use_kernel_threshold=1,
                           fused=fused, fused_min_batch=1, device=CPU)
        v, w = _vecs(np.random.default_rng(2), 2, 32)
        idx = store.insert(v, "old")
        [out] = store.query_batch(v[None], 0.9)   # device-resident now
        assert out[2] == idx and store.last_query_fused == fused
        store.remove(idx)
        assert store.insert(w, "new") == idx      # slot id reused
        [out] = store.query_batch(w[None], 0.9)
        assert out[0] == "new" and out[1] > 0.999 and out[2] == idx
        [out] = store.query_batch(v[None], 0.9)
        assert out[2] is None


class TestMigrationParity:
    """Mirror of tests/test_store_properties.py::TestMigrationParity on the
    port: a migrated bucket range answers like a store built fresh from the
    same entries, and the source's tombstones hold through its fused path."""

    P = LSHParams(dim=32, num_tables=3, num_probes=4, num_buckets=32, seed=11)

    def _fresh(self, **kw):
        # no ring overflow at 300 entries: self-queries measure migration only
        return ReuseStore(self.P, capacity=4096, bucket_cap=32, page_size=16,
                          device=CPU, **kw)

    def _warm_src(self, n=300, **kw):
        src = self._fresh(**kw)
        x = _vecs(np.random.default_rng(21), n, 32)
        src.insert_batch(x, [f"r{i}" for i in range(n)])
        return src, x

    @pytest.mark.parametrize("fused", [False, True])
    def test_migrated_range_answers_identically(self, fused):
        src, x = self._warm_src()
        ids = src.ids_in_bucket_range(8, 23)
        assert len(ids) > 20
        exp = src.extract(ids)
        kw = dict(use_kernel_threshold=1, fused=fused, fused_min_batch=1)
        dst, fresh = self._fresh(**kw), self._fresh(**kw)
        for s in (dst, fresh):
            s.insert_batch(exp.embeddings, exp.results, buckets=exp.buckets)
        assert (dst._slots == fresh._slots).all() and dst.live_ids() == fresh.live_ids()
        got, want = dst.query_batch(x, 0.9), fresh.query_batch(x, 0.9)
        assert got == want and any(idx is not None for _, _, idx in got)

    def test_source_tombstones_survive_fused_requery(self):
        src, x = self._warm_src(use_kernel_threshold=1, fused=True, fused_min_batch=1)
        src.query_batch(x[:4], 0.99)              # both mirrors resident first
        ids = src.ids_in_bucket_range(8, 23)
        exp = src.extract(ids)
        assert src.sync_device() >= 1
        for (_, _, idx), eid in zip(src.query_batch(exp.embeddings, 0.999), exp.ids):
            assert idx != eid and (idx is None or idx not in set(ids))
        rest = src.live_ids()[:8]
        q = np.stack([src.embedding_of(i) for i in rest])
        assert [o[2] for o in src.query_batch(q, 0.999)] == rest

    def test_export_is_pure_read_and_dead_slot_raises(self):
        src, _ = self._warm_src()
        before = src.live_ids()
        exp = src.export(src.ids_in_bucket_range(0, 31))
        assert src.live_ids() == before
        row0 = exp.embeddings[0].copy()
        src.remove(exp.ids[0])
        assert (exp.embeddings[0] == row0).all()
        with pytest.raises(KeyError):
            src.export([exp.ids[0]])
        with pytest.raises(KeyError):
            src.buckets_of(exp.ids[0])
