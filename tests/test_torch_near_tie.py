"""The store's scoring route at near-ties, the port against the JAX package.

The trace (``repro_torch.data.near_tie_trace``): G groups of 8 unit rows
at dim 64, each row perturbed by 1e-6 around its group's base, and one
query per group perturbed the same way, all drawn from a numpy seed.
Inside a group the dots differ below float32's resolution, so a plain dot
(K3, ``gather_top1``) and the host's cosine, which divides by the norms,
often pick different rows.

The reference scores a staged query on the host unless its gather work
(candidates, or queries x candidate width) reaches ``use_kernel_threshold``
(``repro/core/reuse_store.py`` ``query`` and ``_score_batch``).  The port
takes that route on every device (``reuse_store.scores_on_device``):

* below the threshold, scalar ``query`` and staged ``query_batch`` give
  ``(result, similarity, idx)`` equal to the reference's, bit for bit;
* above it both score with a dot (the reference's Pallas ``gather_top1`` in
  interpret mode, the port's plain version of K3): ids equal or a float64
  near-tie, similarities within 1e-6;
* the trace can show the fault: forcing the port onto the kernel's route
  below the threshold (as a CUDA store did before) picks other rows than
  the reference for some queries;
* the route function against the reference's conditions over a grid of
  work and similarity names, and against the reference's store over a
  sweep of thresholds; it takes no device, and a store whose device is a
  card scores small work on the host and raises (no fallback) where the
  route sends it to a device it cannot reach.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels.ops as jops
from repro.core.similarity import SIMILARITY_FNS as J_SIMILARITY_FNS
from repro_torch.core import reuse_store as tstore
from repro_torch.core.lsh import LSHParams
from repro_torch.core.reuse_store import ReuseStore, scores_on_device
from repro_torch.core.similarity import SIMILARITY_FNS
from repro_torch.data import dot_cosine_disagree, near_tie_trace

DIM, GROUP = 64, 8             # near_tie_trace's defaults
N_GROUPS = 64                 # 512 rows: ~150-250 candidates a query
THRESHOLD = 4096              # the stores' default use_kernel_threshold
SIM_TOL = 1e-6                # a dot's fp32 sum order, port vs reference
TIE_MARGIN = 1e-5             # float64 margin under which ids may differ
KW = dict(dim=DIM, num_tables=5, num_probes=8)   # src/repro/launch/serve.py:83


@pytest.fixture(scope="module")
def trace():
    return near_tie_trace(N_GROUPS, seed=0)


def _pair(rows, **kw):
    """The port's CPU store and the reference's staged store, same inserts."""
    n = rows.shape[0] * GROUP
    port = ReuseStore(LSHParams(**KW), capacity=n, device="cpu", fused=False, **kw)
    ref = J.ReuseStore(J.LSHParams(**KW), capacity=n, fused=False, **kw)
    flat = rows.reshape(-1, DIM)
    for s in (port, ref):
        s.insert_batch(flat, [f"r{i}" for i in range(n)])
    return port, ref


def _near_tie(store, q, a, b) -> bool:
    s = store._rows(np.array([a, b])).astype(np.float64) @ q.astype(np.float64)
    return abs(s[0] - s[1]) < TIE_MARGIN


def test_trace_has_dot_cosine_disagreements(trace):
    rows, q = trace
    assert dot_cosine_disagree(rows, q) >= 1


def test_scalar_queries_equal_reference_below_threshold(trace):
    rows, q = trace
    port, ref = _pair(rows)
    for x in q:
        assert len(port.candidates(x)) < THRESHOLD
        assert port.query(x, 0.9) == ref.query(x, 0.9)
    assert port.live_ids() == ref.live_ids()
    assert port.candidate_counts == ref.candidate_counts


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_staged_batches_follow_reference_route(trace, batch):
    """Batches of 1 and 8 stay below the threshold (bit-equal, LRU order
    too); 64 queries reach it (a dot on both sides: near-ties only; peeks,
    since a near-tie would refresh another entry on each side)."""
    rows, q = trace
    port, ref = _pair(rows)
    seen = set()
    for i in range(0, len(q), batch):
        x = q[i:i + batch]
        width = max(len(port.candidates(v)) for v in x)
        above = batch * width >= THRESHOLD
        seen.add(above)
        got, want = port.query_batch(x, 0.9, peek=above), ref.query_batch(x, 0.9, peek=above)
        assert not port.last_query_fused and not ref.last_query_fused
        if not above:
            assert got == want
            continue
        for v, (rg, sg, ig), (rw, sw, iw) in zip(x, got, want):
            assert abs(sg - sw) <= SIM_TOL
            assert ig == iw or _near_tie(port, v, ig, iw)
    assert seen == {batch == 64}
    assert port.live_ids() == ref.live_ids()


def test_kernel_route_below_threshold_would_differ(trace):
    """What a CUDA store did before: K3's dot on small work.  On this trace
    it picks another row than the reference's host cosine for some query."""
    rows, q = trace
    port, ref = _pair(rows)
    port.use_kernel_threshold = 1
    flipped = 0
    for i in range(len(q)):
        got = port.query_batch(q[i:i + 1], 0.0, peek=True)[0]
        want = ref.query_batch(q[i:i + 1], 0.0, peek=True)[0]
        flipped += got[2] != want[2]
    assert flipped >= 1


@pytest.mark.parametrize("work", [0, 1, 4095, 4096, 10**5])
@pytest.mark.parametrize("name", sorted(SIMILARITY_FNS))
def test_route_grid_matches_reference_conditions(name, work):
    """The reference's two conditions (``query``: ``len(cand) >= t and
    cosine``; ``_score_batch``: ``cosine and work >= t``) at t = 4096."""
    assert sorted(SIMILARITY_FNS) == sorted(J_SIMILARITY_FNS)
    want_scalar = work >= THRESHOLD and name == "cosine"
    want_batch = name == "cosine" and work >= THRESHOLD
    assert scores_on_device(name, work, THRESHOLD) == want_scalar == want_batch


def test_route_takes_no_device():
    import inspect

    assert list(inspect.signature(scores_on_device).parameters) == [
        "similarity_name", "work", "use_kernel_threshold"]


@pytest.mark.parametrize("name", sorted(SIMILARITY_FNS))
def test_route_matches_reference_store(trace, monkeypatch, name):
    """Spy on both packages' K3 calls over thresholds around a batch's work:
    the port launches exactly where the reference does."""
    rows, q = trace
    port, ref = _pair(rows[:16], similarity=name)
    x = q[:4]
    work = len(x) * max(len(port.candidates(v)) for v in x)
    calls = {"port": 0, "ref": 0}
    j_gather, t_gather = jops.gathered_top1, tstore._kops.gathered_top1

    def spy(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jops, "gathered_top1", spy("ref", j_gather))
    monkeypatch.setattr(tstore._kops, "gathered_top1", spy("port", t_gather))
    for t in (1, work - 1, work, work + 1, THRESHOLD):
        port.use_kernel_threshold = ref.use_kernel_threshold = t
        before = dict(calls)
        got, want = port.query_batch(x, 0.0, peek=True), ref.query_batch(x, 0.0, peek=True)
        launched = calls["port"] - before["port"]
        assert launched == calls["ref"] - before["ref"]
        assert launched == int(scores_on_device(name, work, t))
        if not launched:
            assert got == want


def test_card_store_scores_small_work_on_the_host(trace):
    """A store whose device is a card takes the same route: small work never
    touches the device (so it runs here without one) and equals the CPU
    store; work at the threshold goes to the device, and without one it
    raises instead of falling back."""
    rows, q = trace
    port, ref = _pair(rows[:16])
    card = ReuseStore(LSHParams(**KW), capacity=16 * GROUP, device="cpu", fused=False)
    card.insert_batch(rows[:16].reshape(-1, DIM), [f"r{i}" for i in range(16 * GROUP)])
    card.device = torch.device("cuda")
    assert card.query_batch(q[:2], 0.9, peek=True) == port.query_batch(q[:2], 0.9, peek=True)
    assert card.query(q[0], 0.9) == port.query(q[0], 0.9)
    card.use_kernel_threshold = 1
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            card.query_batch(q[:2], 0.9, peek=True)
