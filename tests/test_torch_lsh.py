"""The port's LSH layer against the JAX package's, on the CPU.

Parameters, bucket ids and probe ids must be bit-equal for both families;
the plain versions of the hash kernels must equal the Pallas kernels (run in
interpret mode); ranking ties must resolve like ``jax.lax.top_k``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels import lsh_hash as jkern
from repro.kernels import ops as jops
from repro_torch.core import lsh as tlsh
from repro_torch.device import fp32_matmul
from repro_torch.kernels import lsh_hash as tkern
from repro_torch.kernels import ops as tops

CPU = "cpu"


def _rand(n, d, seed=0):
    return tlsh.normalize(np.random.default_rng(seed).standard_normal((n, d)))


def _pair(**kw):
    """(JAX LSH, port LSH on the CPU) for the same parameters."""
    p = dict(kw)
    return jlsh.LSH(jlsh.LSHParams(**p)), tlsh.LSH(tlsh.LSHParams(**p), CPU)


FAMILIES = [
    dict(dim=32, num_tables=3, num_probes=6, seed=7),
    dict(dim=64, num_tables=5, num_probes=8, seed=0),
    dict(dim=32, num_tables=3, rotations_per_table=2, num_probes=6, seed=3),
    dict(dim=16, num_tables=4, rotations_per_table=3, num_buckets=100, num_probes=5, seed=9),
    dict(dim=32, num_tables=3, num_buckets=256, num_probes=6, family="hyperplane", seed=7),
    dict(dim=64, num_tables=5, num_buckets=16384, num_probes=8, family="hyperplane", seed=11),
]


class TestParameters:
    @pytest.mark.parametrize("kw", FAMILIES)
    def test_rotations_and_planes_bitwise_equal(self, kw):
        j, t = _pair(**kw)
        if kw.get("family") == "hyperplane":
            assert t.rotations is None
            assert np.array_equal(np.asarray(j.planes), t.planes.numpy())
        else:
            assert t.planes is None
            assert np.array_equal(np.asarray(j.rotations), t.rotations.numpy())

    def test_params_field_for_field(self):
        a = jlsh.LSHParams(dim=8, num_buckets=257)
        b = tlsh.LSHParams(dim=8, num_buckets=257)
        assert dataclass_fields(a) == dataclass_fields(b)
        assert (a.index_size_bytes, a.effective_buckets) == (b.index_size_bytes,
                                                              b.effective_buckets)
        with pytest.raises(ValueError):
            _ = tlsh.LSHParams(dim=8, num_buckets=1 << 33).index_size_bytes


def dataclass_fields(x):
    import dataclasses

    return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]


class TestCrossPackage:
    @pytest.mark.parametrize("kw", FAMILIES)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_hash_and_probe_bit_equal(self, kw, seed):
        j, t = _pair(**kw)
        x = _rand(40, kw["dim"], seed=seed)
        hj, ht = np.asarray(j.hash_batch(x)), t.hash_batch(x).numpy()
        assert ht.dtype == hj.dtype == np.int32
        assert np.array_equal(hj, ht)
        bj, lj = map(np.asarray, j._probe_jit(x))
        bt, lt = (v.numpy() for v in t.probe_scores(x))
        assert bt.dtype == np.int32
        assert np.array_equal(bj, bt)
        np.testing.assert_allclose(lt, lj, atol=1e-5)

    def test_hash_one_and_probe_one(self):
        j, t = _pair(**FAMILIES[0])
        v = _rand(1, 32, seed=4)[0]
        assert np.array_equal(j.hash_one(v), t.hash_one(v))
        assert np.array_equal(j.probe_one(v), t.probe_one(v))


class TestHashing:
    """Mirror of tests/test_lsh.py::TestHashing on the port."""

    @pytest.fixture(scope="class")
    def cp(self):
        return tlsh.get_lsh(tlsh.LSHParams(dim=32, num_tables=3, num_probes=6, seed=7), CPU)

    def test_shapes_and_range(self, cp):
        h = cp.hash_batch(_rand(10, 32)).numpy()
        assert h.shape == (10, 3) and h.dtype == np.int32
        assert (h >= 0).all() and (h < 256).all()

    def test_deterministic_and_scale_invariant(self, cp):
        x = _rand(5, 32, seed=3)
        h = cp.hash_batch(x).numpy()
        assert (h == cp.hash_batch(x).numpy()).all()
        assert (h == cp.hash_batch(x * 7.5).numpy()).all()

    def test_similar_inputs_collide_more(self, cp):
        rng = np.random.default_rng(0)
        base = _rand(50, 32, seed=1)
        near = tlsh.normalize(base + 0.05 * rng.standard_normal(base.shape) / np.sqrt(32))
        hb, hn = cp.hash_batch(base).numpy(), cp.hash_batch(near).numpy()
        hf = cp.hash_batch(_rand(50, 32, seed=2)).numpy()
        assert (hb == hn).mean() > 0.9
        assert (hb == hn).mean() > (hb == hf).mean() + 0.5

    def test_get_lsh_caches_per_device(self):
        p = tlsh.LSHParams(dim=16, num_tables=2, seed=1)
        assert tlsh.get_lsh(p, CPU) is tlsh.get_lsh(p, torch.device("cpu"))


class TestHashOps:
    """``ops.lsh_hash_ids`` and ``ops.lsh_buckets`` (K4b's and K4a's callers)
    against the reference's, which run the Pallas kernels in interpret mode."""

    @pytest.mark.parametrize("B,D,T,K", [(8, 64, 1, 1), (33, 128, 5, 2), (7, 32, 2, 3),
                                         (1, 64, 5, 1)])
    def test_lsh_hash_ids(self, B, D, T, K):
        rng = np.random.default_rng(B + D)
        x = rng.standard_normal((B, D)).astype(np.float32)
        rot = rng.standard_normal((T, K, D, D)).astype(np.float32)
        got = tops.lsh_hash_ids(torch.from_numpy(x), torch.from_numpy(rot))
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, T, K)
        assert np.array_equal(got.numpy(), np.asarray(jops.lsh_hash_ids(jnp.asarray(x),
                                                                       jnp.asarray(rot))))

    @pytest.mark.parametrize("kw", [dict(dim=64, num_tables=4, rotations_per_table=2,
                                         num_buckets=256, seed=3),
                                    dict(dim=32, num_tables=3, num_probes=6, seed=7)])
    def test_lsh_buckets(self, kw):
        j, t = _pair(**kw)
        x = _rand(19, kw["dim"], seed=4)
        nb = t.params.num_buckets
        got = tops.lsh_buckets(torch.from_numpy(x), t.rotations, nb)
        want = np.asarray(jops.lsh_buckets(jnp.asarray(x), j.rotations, nb))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), t.hash_batch(x).numpy())


class TestMultiProbe:
    """Mirror of tests/test_lsh.py::TestMultiProbe on the port."""

    @pytest.mark.parametrize("family", ["cross_polytope", "hyperplane"])
    def test_probe_zero_is_hash(self, family):
        t = tlsh.LSH(tlsh.LSHParams(dim=32, num_tables=3, num_probes=6,
                                    family=family, seed=7), CPU)
        x = _rand(8, 32, seed=5)
        p = t.probe_batch(x).numpy()
        assert p.shape == (8, 3, 6)
        assert (p[:, :, 0] == t.hash_batch(x).numpy()).all()

    def test_probes_ranked_and_catch_neighbours(self):
        t = tlsh.LSH(tlsh.LSHParams(dim=32, num_tables=3, num_probes=6, seed=7), CPU)
        buckets, losses = (v.numpy() for v in t.probe_scores(_rand(8, 32, seed=6)))
        assert (buckets >= 0).all() and (buckets < 256).all()
        assert (np.diff(losses, axis=-1) >= -1e-5).all()
        rng = np.random.default_rng(2)
        base = _rand(100, 32, seed=7)
        near = tlsh.normalize(base + 0.15 * rng.standard_normal(base.shape) / np.sqrt(32))
        hb = t.hash_batch(base).numpy()
        hit = (t.probe_batch(near).numpy() == hb[:, :, None]).any(-1).mean()
        assert hit > 0.95


class TestProperties:
    """Mirror of tests/test_lsh.py::TestProperties on the port (seeded sweep
    in place of hypothesis)."""

    @pytest.mark.parametrize("seed", range(6))
    def test_bucket_range(self, seed):
        t = tlsh.get_lsh(tlsh.LSHParams(dim=16, num_tables=2, num_buckets=64,
                                        num_probes=4, seed=3), CPU)
        h = t.hash_batch(_rand(4, 16, seed=seed)).numpy()
        assert ((h >= 0) & (h < 64)).all()

    @pytest.mark.parametrize("noise", [0.0, 0.2, 0.5])
    def test_collision_monotonic_in_noise(self, noise):
        t = tlsh.get_lsh(tlsh.LSHParams(dim=32, num_tables=8, num_probes=2, seed=11), CPU)
        rng = np.random.default_rng(17)
        base = _rand(30, 32, seed=13)
        n1 = tlsh.normalize(base + noise * rng.standard_normal(base.shape) / np.sqrt(32))
        n2 = tlsh.normalize(base + (noise + 0.5) * rng.standard_normal(base.shape) / np.sqrt(32))
        hb = t.hash_batch(base).numpy()
        c1 = (t.hash_batch(n1).numpy() == hb).mean()
        c2 = (t.hash_batch(n2).numpy() == hb).mean()
        assert c1 >= c2 - 0.12


class TestHashKernelsPlain:
    """The hash kernels' plain versions against the Pallas kernels (interpret)."""

    @pytest.mark.parametrize("T,K,NB,D", [(3, 1, 256, 32), (3, 2, 256, 32),
                                          (2, 3, 100, 16), (5, 1, 256, 64)])
    def test_lsh_hash_mix_matches_pallas(self, T, K, NB, D):
        t = tlsh.LSH(tlsh.LSHParams(dim=D, num_tables=T, rotations_per_table=K,
                                    num_buckets=NB, seed=21), CPU)
        x = _rand(37, D, seed=8)
        want = np.asarray(jkern.lsh_hash_mix(jnp.asarray(x), jnp.asarray(t.rotations.numpy()),
                                             num_buckets=NB))
        got = tkern.lsh_hash_mix(torch.from_numpy(x), t.rotations, NB).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want)

    @pytest.mark.parametrize("T,K,D", [(3, 1, 32), (2, 3, 16)])
    def test_lsh_hash_matches_pallas(self, T, K, D):
        t = tlsh.LSH(tlsh.LSHParams(dim=D, num_tables=T, rotations_per_table=K, seed=4), CPU)
        x = _rand(20, D, seed=9)
        want = np.asarray(jkern.lsh_hash(jnp.asarray(x), jnp.asarray(t.rotations.numpy())))
        got = tkern.lsh_hash(torch.from_numpy(x), t.rotations).numpy()
        assert got.shape == (20, T, K) and np.array_equal(got, want)

    def test_wrapper_rejects_bad_inputs(self):
        rot = torch.zeros((2, 1, 8, 8))
        with pytest.raises(TypeError):
            tkern.lsh_hash(torch.zeros((4, 8), dtype=torch.float64), rot)
        with pytest.raises(ValueError):
            tkern.lsh_hash(torch.zeros((4, 6)), rot)
        with pytest.raises(ValueError):
            tkern.lsh_hash(torch.zeros((8, 4)).T, rot)


class TestTieOrder:
    def test_top_k_matches_lax_top_k_on_ties(self):
        rng = np.random.default_rng(0)
        x = rng.integers(0, 4, (6, 5, 40)).astype(np.float32)  # many exact ties
        for k in (1, 3, 10, 40):
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            tv, ti = tlsh.top_k(torch.from_numpy(x), k)
            assert np.array_equal(np.asarray(jv), tv.numpy())
            assert np.array_equal(np.asarray(ji), ti.numpy())

    @pytest.mark.parametrize("family", ["cross_polytope", "hyperplane"])
    def test_multiprobe_with_constructed_ties(self, family):
        """Identity rotations / axis planes and inputs with equal coordinates:
        vertex scores and margins tie exactly, and both packages must rank
        the probes the same way."""
        d, t = 8, 2
        if family == "cross_polytope":
            proj = np.broadcast_to(np.eye(d, dtype=np.float32), (t, 1, d, d)).copy()
            nb = 256
        else:
            proj = np.broadcast_to(np.eye(d, dtype=np.float32)[:4], (t, 4, d)).copy()
            nb = 16
        x = np.zeros((4, d), np.float32)
        x[0, :4] = 0.5
        x[1, [1, 3, 5, 7]] = [0.5, -0.5, 0.5, -0.5]
        x[2, :] = 1 / np.sqrt(d)
        x[3, [0, 2]] = [-0.6, 0.6]
        kw = dict(family=family, dim=d, rotations_per_table=1, num_probes=6, num_buckets=nb)
        bj, lj = jlsh.multiprobe_buckets(jnp.asarray(x), jnp.asarray(proj), **kw)
        bt, lt = tlsh.multiprobe_buckets(torch.from_numpy(x), torch.from_numpy(proj), **kw)
        assert np.array_equal(np.asarray(bj), bt.numpy())
        np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


class TestMatmulPrecision:
    """The port's hash, probe and cosine matmuls stay full fp32 when the
    process lowers the float32 matmul precision, and leave it as they found
    it."""

    @pytest.fixture
    def lowered(self):
        torch.set_float32_matmul_precision("medium")
        yield
        torch.set_float32_matmul_precision("highest")

    @pytest.mark.parametrize("kw", [FAMILIES[1], FAMILIES[5]])
    def test_hash_and_probe_unchanged(self, kw, lowered):
        j, t = _pair(**kw)
        x = _rand(64, kw["dim"], seed=12)
        assert np.array_equal(np.asarray(j.hash_batch(x)), t.hash_batch(x).numpy())
        assert np.array_equal(np.asarray(j._probe_jit(x)[0]), t.probe_batch(x).numpy())
        assert torch.get_float32_matmul_precision() == "medium"

    def test_similarity_scores_full_fp32(self, lowered):
        q, s = _rand(8, 64, seed=1), _rand(300, 64, seed=2)
        got = tops.similarity_scores(torch.from_numpy(q), torch.from_numpy(s)).numpy()
        np.testing.assert_allclose(got, q.astype(np.float64) @ s.T.astype(np.float64),
                                   atol=1e-6)
        assert torch.get_float32_matmul_precision() == "medium"

    def test_context_restores_on_error(self, lowered):
        with pytest.raises(KeyError):
            with fp32_matmul():
                assert torch.get_float32_matmul_precision() == "highest"
                raise KeyError
        assert torch.get_float32_matmul_precision() == "medium"
