"""Recall under ring overflow, the port against the JAX package.

Mirror of tests/test_store_properties.py ``TestRingOverflowRecall``: 600
seeded unit rows at dim 32 into a store whose buckets overflow (4 tables,
64 buckets, bucket_cap 2 to 16), every row queried back against a
brute-force oracle.  ``overflows`` must equal the analytic displacement
count, and recall must clear the reference's pinned floors (0.30, 0.60,
0.90, 0.98 at caps 2, 4, 8, 16) and rise with the cap (within 0.02).

The port runs it on both of its paths: fused (600 queries >= the store's
``fused_min_batch``: one ``reuse_query_top1`` call, K1's plain version on
the CPU) and staged (``fused = False``: host candidate matrix, K3's plain
version).  The reference's own test takes its fused path, which reaches
``pl.load`` (gone from this JAX); its staged path runs here, and the port's
staged recalls equal it, the fused recalls the staged ones.
"""
import numpy as np
import pytest

import repro.core as J
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.core.reuse_store import ReuseStore

CAPS = (2, 4, 8, 16)
FLOORS = {2: 0.30, 4: 0.60, 8: 0.90, 16: 0.98}


def _overflowed_store(pkg, n=600, bucket_cap=4):
    """The reference's ``_overflowed_store`` in either package."""
    kw = dict(dim=32, num_tables=4, num_probes=8, num_buckets=64, seed=9)
    if pkg == "port":
        store = ReuseStore(LSHParams(**kw), capacity=10 * n, bucket_cap=bucket_cap,
                           device="cpu")
    else:
        store = J.ReuseStore(J.LSHParams(**kw), capacity=10 * n, bucket_cap=bucket_cap)
    X = normalize(np.random.default_rng(17).standard_normal((n, 32)).astype(np.float32))
    buckets = np.asarray(store.lsh.hash_batch(X))
    store.insert_batch(X, list(range(n)), buckets=buckets)
    return store, X, buckets


def _recall(store, X, fused: bool) -> float:
    store.fused = fused
    out = store.query_batch(X, 0.0, peek=True)
    assert store.last_query_fused == fused
    rows = np.stack([store.embedding_of(i) for i in range(len(X))])
    oracle = np.argmax(X @ rows.T, axis=1)
    got = np.asarray([-1 if idx is None else idx for _, _, idx in out])
    return float((got == oracle).mean())


@pytest.fixture(scope="module")
def recalls():
    """{(package, path): {cap: recall}}."""
    out = {}
    for cap in CAPS:
        port, X, _ = _overflowed_store("port", bucket_cap=cap)
        ref, _, _ = _overflowed_store("ref", bucket_cap=cap)
        out.setdefault(("port", "fused"), {})[cap] = _recall(port, X, True)
        out.setdefault(("port", "staged"), {})[cap] = _recall(port, X, False)
        out.setdefault(("ref", "staged"), {})[cap] = _recall(ref, X, False)
    return out


def test_overflows_match_analytic_count():
    store, X, buckets = _overflowed_store("port")
    want = 0
    for t in range(store.params.num_tables):
        _, counts = np.unique(buckets[:, t], return_counts=True)
        want += int(np.maximum(counts - store.bucket_cap, 0).sum())
    assert want > 0, "scenario must actually overflow"
    assert store.overflows == want
    ref, _, ref_buckets = _overflowed_store("ref")
    assert (ref_buckets == buckets).all() and ref.overflows == want


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_self_query_recall_above_pinned_floors(recalls, path):
    got = recalls[("port", path)]
    for cap in CAPS:
        assert got[cap] >= FLOORS[cap], got
    assert all(got[a] <= got[b] + 0.02 for a, b in zip(CAPS, CAPS[1:])), got


def test_recalls_equal_reference_staged(recalls):
    assert recalls[("port", "staged")] == recalls[("ref", "staged")]
    assert recalls[("port", "fused")] == recalls[("port", "staged")]
