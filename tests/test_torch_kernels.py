"""The port's top-1 kernels against the JAX package, on the CPU.

On the CPU the wrappers run the kernels' plain versions (``kernels/ref.py``):
they are held against the Pallas ``gather_top1`` in interpret mode and
against the JAX oracles ``ref.gather_top1_ref`` / ``ref.reuse_top1_ref``.
Ids must be equal; scores agree within the reference's own tolerance
(``SIM_TOL = 1e-4``, tests/test_store_properties.py).  The CUDA kernels
themselves are held against these plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels import ref as jref
from repro.kernels import sim_topk as jtopk
from repro_torch.core import lsh as tlsh
from repro_torch.kernels import fused_query as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sim_topk as ttopk

SIM_TOL = 1e-4
RNG = np.random.default_rng(0)


def _unit(*shape, rng=RNG):
    return tlsh.normalize(rng.standard_normal(shape).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sorted_unique_ids(q, n, c, rng=RNG):
    """(q, c) front-packed ascending unique ids, -1 padded, one empty row."""
    ids = np.full((q, c), -1, np.int32)
    for r in range(1, q):
        k = int(rng.integers(1, c + 1))
        ids[r, :k] = np.sort(rng.choice(n, min(k, n), replace=False))[:k]
    return ids


def _assert_same(got, want):
    gv, gi = (np.asarray(v) for v in got)
    wv, wi = (np.asarray(v) for v in want)
    assert np.array_equal(gi, wi)
    fin = np.isfinite(wv)
    assert (np.isfinite(gv) == fin).all()
    np.testing.assert_allclose(gv[fin], wv[fin], atol=SIM_TOL)


class TestGatherTop1Plain:
    @pytest.mark.parametrize("Q,N,C,D", [(8, 64, 16, 32), (33, 1000, 200, 64),
                                         (17, 300, 64, 48)])
    def test_matches_pallas_and_oracle(self, Q, N, C, D):
        q, s = _unit(Q, D), _unit(N, D)
        ids = _sorted_unique_ids(Q, N, C)
        got = ttopk.gather_top1(_t(q), _t(s), _t(ids))
        _assert_same(got, jtopk.gather_top1(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids)))
        _assert_same(got, jref.gather_top1_ref(jnp.asarray(q), jnp.asarray(s),
                                               jnp.asarray(ids)))
        assert got[1][0] == -1 and np.isneginf(got[0][0].item())

    @pytest.mark.parametrize("P,S,D,C", [(4, 16, 32, 20), (8, 8, 16, 64)])
    def test_paged_matches_pallas_and_flat(self, P, S, D, C):
        flat = _unit(P * S, D)
        paged = flat.reshape(P, S, D)
        q = _unit(12, D)
        ids = _sorted_unique_ids(12, P * S, C)
        got = ttopk.gather_top1(_t(q), _t(paged), _t(ids))
        _assert_same(got, jtopk.gather_top1(jnp.asarray(q), jnp.asarray(paged),
                                            jnp.asarray(ids)))
        _assert_same(got, ttopk.gather_top1(_t(q), _t(flat), _t(ids)))

    def test_first_position_wins_ties(self):
        s = _unit(32, 16)
        s[20] = s[4]
        q = s[4:5]
        ids = np.array([[4, 20, -1, -1]], np.int32)
        _, idx = ttopk.gather_top1(_t(q), _t(s), _t(ids))
        assert idx.item() == 4
        _, wi = jtopk.gather_top1(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids))
        assert int(wi[0]) == 4

    def test_ops_empty_store_and_no_candidates(self):
        q = _t(_unit(3, 16))
        val, idx = tops.gathered_top1(q, torch.zeros((0, 8, 16)), _t(np.zeros((3, 4), np.int32)))
        assert (idx == -1).all() and torch.isneginf(val).all()
        val, idx = tops.gathered_top1(q, _t(_unit(8, 16)), torch.zeros((3, 0), dtype=torch.int32))
        assert (idx == -1).all() and torch.isneginf(val).all()


class TestReuseTop1Plain:
    @pytest.mark.parametrize("Q,N,C,D", [(8, 64, 16, 32), (33, 1000, 200, 64),
                                         (128, 4096, 700, 32), (5, 50, 7, 64)])
    def test_matches_oracle(self, Q, N, C, D):
        q, s = _unit(Q, D), _unit(N, D)
        ids = RNG.integers(-1, N, (Q, C)).astype(np.int32)
        _assert_same(ttopk.reuse_top1(_t(q), _t(s), _t(ids)),
                     jref.reuse_top1_ref(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids)))

    def test_lowest_id_wins_ties_regardless_of_order(self):
        s = _unit(64, 32)
        s[40] = s[3]
        s[57] = s[3]
        q = s[3:4]
        for order in ([40, 7, 3, 57, -1, 3], [57, 40, 3, 3, 7, -1], [3, 57, 40, -1, -1, 7]):
            ids = np.asarray([order], np.int32)
            _, idx = ttopk.reuse_top1(_t(q), _t(s), _t(ids))
            assert idx.item() == 3, order
            _, wi = jref.reuse_top1_ref(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids))
            assert int(wi[0]) == 3, order

    def test_tie_across_candidate_tiles(self):
        """The lower equal-similarity id sits far behind a higher one (a later
        tile of the Pallas kernel's grid): it must still win."""
        s = _unit(256, 32)
        s[200] = s[5]
        ids = np.full((1, 128), -1, np.int32)
        ids[0, 0], ids[0, 100] = 200, 5
        _, idx = ttopk.reuse_top1(_t(s[5:6]), _t(s), _t(ids))
        assert idx.item() == 5

    def test_duplicates_score_bit_equal(self):
        s = _unit(40, 16)
        q = _unit(6, 16)
        ids = np.tile(RNG.integers(0, 40, (6, 1)), (1, 12)).astype(np.int32)
        val, idx = ttopk.reuse_top1(_t(q), _t(s), _t(ids))
        assert (idx.numpy() == ids[:, 0]).all()
        np.testing.assert_allclose(val.numpy(), (q * s[ids[:, 0]]).sum(-1), atol=1e-6)

    @pytest.mark.parametrize("gather_mode", ["take", "onehot"])
    def test_paged_matches_flat(self, gather_mode):
        P, S, D, C = 8, 32, 32, 40
        flat = _unit(P * S, D)
        q = _unit(12, D)
        ids = RNG.integers(-1, P * S, (12, C)).astype(np.int32)
        got = ttopk.reuse_top1(_t(q), _t(flat.reshape(P, S, D)), _t(ids),
                               gather_mode=gather_mode)
        _assert_same(got, ttopk.reuse_top1(_t(q), _t(flat), _t(ids)))
        _assert_same(got, jref.reuse_top1_ref(jnp.asarray(q), jnp.asarray(flat.reshape(P, S, D)),
                                              jnp.asarray(ids)))

    def test_onehot_matches_take(self):
        q, s = _unit(16, 32), _unit(128, 32)
        ids = _t(RNG.integers(-1, 128, (16, 40)).astype(np.int32))
        a = ttopk.reuse_top1(_t(q), _t(s), ids, gather_mode="take")
        b = ttopk.reuse_top1(_t(q), _t(s), ids, gather_mode="onehot")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        with pytest.raises(ValueError):
            ttopk.reuse_top1(_t(q), _t(s), ids, gather_mode="scatter")

    def test_no_candidates_row(self):
        q, s = _unit(4, 32), _unit(64, 32)
        val, idx = ttopk.reuse_top1(_t(q), _t(s), torch.full((4, 10), -1, dtype=torch.int32))
        assert (idx == -1).all() and torch.isneginf(val).all()

    def test_wrapper_rejects_bad_inputs(self):
        q, s = _t(_unit(4, 8)), _t(_unit(16, 8))
        ids = torch.zeros((4, 3), dtype=torch.int32)
        with pytest.raises(TypeError):
            ttopk.reuse_top1(q, s, ids.long())
        with pytest.raises(TypeError):
            ttopk.gather_top1(q.double(), s, ids)
        with pytest.raises(ValueError):
            ttopk.reuse_top1(q, s[:, :4].contiguous(), ids)
        with pytest.raises(ValueError):
            ttopk.gather_top1(q, s, torch.zeros((4, 6), dtype=torch.int32)[:, ::2])


class TestFusedPipelinePlain:
    """Port pipeline (probe -> table gather -> top-1 -> counts) against the
    same steps composed from the JAX package's probe math and oracle."""

    @pytest.mark.parametrize("family,T,P_probe,NB,cap", [
        ("cross_polytope", 3, 4, 64, 8), ("cross_polytope", 2, 6, 256, 4),
        ("hyperplane", 3, 4, 64, 8)])
    def test_matches_jax_composed_oracle(self, family, T, P_probe, NB, cap):
        D, N, B = 16, 300, 40
        kw = dict(dim=D, num_tables=T, num_probes=P_probe, num_buckets=NB,
                  family=family, seed=5)
        jl = jlsh.LSH(jlsh.LSHParams(**kw))
        tl = tlsh.LSH(tlsh.LSHParams(**kw), "cpu")
        store = _unit(N, D)
        slots = RNG.integers(-1, N, (T * NB, cap)).astype(np.int32)
        q = _unit(B, D)
        proj = jl.rotations if family == "cross_polytope" else jl.planes
        buckets, _ = jlsh.multiprobe_buckets(
            jnp.asarray(q), proj, family=family, dim=D,
            rotations_per_table=1, num_probes=P_probe, num_buckets=NB)
        cand = slots.reshape(T, NB, cap)[np.arange(T)[None, :, None],
                                         np.asarray(buckets)].reshape(B, -1)
        want = jref.reuse_top1_ref(jnp.asarray(q), jnp.asarray(store), jnp.asarray(cand))
        pages = _t(store.reshape(N // 10, 10, D))
        val, idx, counts = tops.reuse_query_top1(_t(q), tl, _t(slots), pages)
        _assert_same((val, idx), want)
        assert np.array_equal(counts.numpy(), tops.unique_counts(cand))
        # with_counts: the device-side sort epilogue gives the same counts
        _, _, dev_counts = tfused.fused_query(
            _t(q), tl.rotations if family == "cross_polytope" else tl.planes,
            _t(slots), pages, family=family, num_probes=P_probe)
        assert np.array_equal(dev_counts.numpy(), tops.unique_counts(cand))
