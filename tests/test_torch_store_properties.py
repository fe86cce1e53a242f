"""The port's ReuseStore against the reference's dict-of-lists model.

The op interleavings of tests/test_store_properties.py (insert,
insert_batch, query, query_batch with peek, remove, bucket-range migration,
capacity-driven eviction) run on the port's store on the CPU, side by side
with that file's ``RefStore`` model, whose probes come from the JAX
package's LSH.  After every op the state checks of that file hold: hit/miss,
similarity (``SIM_TOL``), winning id outside ties, LRU order, candidate
statistics, bucket tables, and tombstoned page rows.  The staged
(gather_top1) path runs here, the fused (reuse_top1) path in
tests/test_torch_store_properties_fused.py, each over the reference's 200
seeds (``1000 + s`` staged, ``2000 + s`` fused).
"""
from typing import List

import numpy as np
import pytest
from test_store_properties import DIM, RefStore, _assert_state, _check_query

from repro.core.lsh import LSHParams as JParams
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore


def run_interleaving(seed: int, fused: bool) -> None:
    rng = np.random.default_rng(seed)
    kw = dict(dim=DIM, num_tables=int(rng.integers(2, 4)), num_probes=4,
              num_buckets=32, seed=int(rng.integers(1 << 16)))
    capacity = int(rng.integers(6, 24))
    bucket_cap = int(rng.integers(2, 5))
    store = ReuseStore(LSHParams(**kw), capacity=capacity, bucket_cap=bucket_cap,
                       page_size=int(rng.choice([4, 8, 16])), use_kernel_threshold=1,
                       fused=fused, fused_min_batch=1, device="cpu")
    model = RefStore(JParams(**kw), capacity, bucket_cap)
    inserted: List[np.ndarray] = []
    uid = 0

    def vec() -> np.ndarray:
        if inserted and rng.random() < 0.5:
            base = inserted[int(rng.integers(len(inserted)))]
            return normalize(base + 0.05 * rng.standard_normal(DIM).astype(np.float32))
        return normalize(rng.standard_normal(DIM).astype(np.float32))

    for _ in range(18):
        op = rng.choice(["insert", "insert_batch", "query", "query_batch", "remove",
                         "migrate"], p=[0.27, 0.18, 0.13, 0.22, 0.08, 0.12])
        if op == "insert":
            v = vec()
            inserted.append(v)
            assert store.insert(v, f"r{uid}") == model.insert(v, f"r{uid}")
            uid += 1
        elif op == "insert_batch":
            n = int(rng.integers(1, 6))
            vs = np.stack([vec() for _ in range(n)])
            inserted.extend(vs)
            res = [f"r{uid + i}" for i in range(n)]
            uid += n
            assert store.insert_batch(vs, res) == model.insert_batch(vs, res)
        elif op == "query":
            v, thr = vec(), float(rng.choice([0.0, 0.5, 0.9, 0.97]))
            _check_query(store, model, v, thr, store.query(v, thr))
        elif op == "query_batch":
            n = int(rng.integers(1, 6))
            vs = np.stack([vec() for _ in range(n)])
            thrs = rng.choice([0.0, 0.5, 0.9, 0.97], n).astype(np.float32)
            peek = bool(rng.random() < 0.2)
            routed = len(store) > 0      # an empty store answers without a path
            outs = store.query_batch(vs, thrs, peek=peek)
            assert not routed or store.last_query_fused == fused
            for v, t, out in zip(vs, thrs, outs):
                _check_query(store, model, v, float(t), out, peek=peek)
        elif op == "remove":
            live = store.live_ids()
            if live:
                idx = int(live[int(rng.integers(len(live)))])
                store.remove(idx)
                model.remove(idx)
        else:  # bucket-range extract + landing with admission-time buckets
            lo = int(rng.integers(0, 32))
            hi = int(rng.integers(lo, 32))
            ids = store.ids_in_bucket_range(lo, hi)
            assert ids == model.ids_in_bucket_range(lo, hi)
            if ids:
                exp = store.extract(ids)
                m_embs, m_res, m_bks = model.extract(ids)
                assert exp.ids == ids and exp.results == m_res
                assert (exp.embeddings == m_embs).all() and (exp.buckets == m_bks).all()
                _assert_state(store, model)
                assert (store.insert_batch(exp.embeddings, exp.results, buckets=exp.buckets)
                        == model.insert_batch(m_embs, m_res, buckets=m_bks))
        _assert_state(store, model)


class TestPortStoreProperties:
    @pytest.mark.parametrize("seed", range(200))
    def test_interleaving_parity_staged(self, seed):
        run_interleaving(1000 + seed, fused=False)
