"""The bucket-major K1 route and the register-tiled hash's launch plan, on the CPU.

``reuse_top1_probed`` scores the probed slot rows of the fused query without
the (B, T*P*cap) id matrix; on the CPU it runs its plain version, which is
held here against the JAX oracle ``ref.reuse_top1_ref`` applied to
``slots[t, buckets]`` built from the JAX ``multiprobe_buckets``.  Ids must be
equal; scores agree within the reference's own tolerance (``SIM_TOL``,
tests/test_store_properties.py).  The probe inversion the CUDA kernel reads
(offsets and prober order) and the hash kernel's launch plan are plain Python
and torch, so they are held to their contracts here too; the kernels
themselves are held against these plain versions in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.kernels import ref as jref
from repro_torch.core import lsh as tlsh
from repro_torch.kernels import build
from repro_torch.kernels import fused_query as tfused
from repro_torch.kernels import lsh_hash as tlsh_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sim_topk as ttopk

SIM_TOL = 1e-4
SMS = 132


def _unit(rng, *shape):
    return tlsh.normalize(rng.standard_normal(shape).astype(np.float32))


CASES = [("cross_polytope", 5, 8, 256, 16), ("cross_polytope", 3, 4, 64, 8),
         ("cross_polytope", 2, 6, 32, 70), ("hyperplane", 5, 8, 1024, 6),
         ("hyperplane", 3, 4, 64, 8)]


@pytest.mark.parametrize("family,T,P,NB,cap", CASES)
def test_probed_plain_matches_jax_oracle(family, T, P, NB, cap):
    rng = np.random.default_rng(T * NB + cap)
    D, N, B = 16, 400, 48
    kw = dict(dim=D, num_tables=T, num_probes=P, num_buckets=NB, family=family, seed=3)
    jl = jlsh.LSH(jlsh.LSHParams(**kw))
    tl = tlsh.LSH(tlsh.LSHParams(**kw), "cpu")
    store = _unit(rng, N, D)
    store[N - 1] = store[7]                              # equal rows: 7 wins
    slots = rng.integers(-1, N, (T * NB, cap)).astype(np.int32)
    q = _unit(rng, B, D)
    q[0] = store[7]
    proj = jl.rotations if family == "cross_polytope" else jl.planes
    jb, _ = jlsh.multiprobe_buckets(jnp.asarray(q), proj, family=family, dim=D,
                                    rotations_per_table=1, num_probes=P, num_buckets=NB)
    jb = np.asarray(jb)
    slots[jb[0, 0, 0], :2] = [N - 1, 7]                  # both in query 0's first probe
    cand = slots.reshape(T, NB, cap)[np.arange(T)[None, :, None], jb].reshape(B, -1)
    want = jref.reuse_top1_ref(jnp.asarray(q), jnp.asarray(store), jnp.asarray(cand))
    tb = tl.probe_batch(torch.from_numpy(q))
    assert np.array_equal(tb.numpy(), jb)
    for pages in (store, store.reshape(N // 8, 8, D)):
        val, idx = ttopk.reuse_top1_probed(torch.from_numpy(q), torch.from_numpy(pages),
                                           torch.from_numpy(slots), tb.contiguous())
        assert np.array_equal(idx.numpy(), np.asarray(want[1]))
        fin = np.isfinite(np.asarray(want[0]))
        assert np.array_equal(np.isfinite(val.numpy()), fin)
        np.testing.assert_allclose(val.numpy()[fin], np.asarray(want[0])[fin], atol=SIM_TOL)
        assert idx[0].item() == 7
    ids = tref.probed_candidate_ids(torch.from_numpy(slots), tb)
    assert np.array_equal(ids.numpy(), cand)


def test_probed_no_candidate_and_gather_mode():
    rng = np.random.default_rng(1)
    q, s = torch.from_numpy(_unit(rng, 4, 8)), torch.from_numpy(_unit(rng, 20, 8))
    slots = torch.full((6, 5), -1, dtype=torch.int32)
    slots[0, 2] = 11
    buckets = torch.tensor([[[0], [0]], [[1], [1]], [[2], [2]], [[2], [0]]], dtype=torch.int32)
    for mode in ("take", "onehot"):
        val, idx = ttopk.reuse_top1_probed(q, s, slots, buckets, gather_mode=mode)
        assert idx.tolist() == [11, -1, -1, -1] and torch.isneginf(val[1:]).all()
    with pytest.raises(ValueError):
        ttopk.reuse_top1_probed(q, s, slots, buckets, gather_mode="scatter")
    with pytest.raises(TypeError):
        ttopk.reuse_top1_probed(q, s, slots.long(), buckets)
    with pytest.raises(ValueError):
        ttopk.reuse_top1_probed(q, s, slots[:5], buckets)      # 5 rows, 2 tables


@pytest.mark.parametrize("B,T,P,NB", [(40, 5, 8, 256), (7, 3, 4, 16), (1, 2, 3, 8),
                                      (300, 2, 6, 4)])
def test_probe_inversion_matches_numpy(B, T, P, NB):
    rng = np.random.default_rng(B + NB)
    buckets = rng.integers(0, max(NB // 2, 1), (B, T, P)).astype(np.int32)   # upper half unprobed
    offsets, probers = ttopk.probe_inversion(torch.from_numpy(buckets), NB)
    assert offsets.dtype == torch.int32 and probers.dtype == torch.int32
    off, prb = offsets.numpy(), probers.numpy()
    assert off.shape == (T * NB + 1,) and off[0] == 0 and off[-1] == B * T * P
    for t in range(T):
        for nb in range(NB):
            want = [b for b in range(B) for p in range(P) if buckets[b, t, p] == nb]
            r = t * NB + nb
            assert prb[off[r]:off[r + 1]].tolist() == want          # query order
    assert (np.diff(off)[[t * NB + nb for t in range(T) for nb in range(NB // 2, NB)]]
            == 0).all()


def test_fused_counts_only_on_request():
    rng = np.random.default_rng(2)
    kw = dict(dim=16, num_tables=3, num_probes=4, num_buckets=64, seed=5)
    tl = tlsh.LSH(tlsh.LSHParams(**kw), "cpu")
    slots = torch.from_numpy(rng.integers(-1, 200, (3 * 64, 8)).astype(np.int32))
    pages = torch.from_numpy(_unit(rng, 200, 16).reshape(25, 8, 16))
    q = torch.from_numpy(_unit(rng, 16, 16))
    a = tfused.fused_query(q, tl.rotations, slots, pages, family="cross_polytope",
                           num_probes=4, with_counts=False)
    b = tfused.fused_query(q, tl.rotations, slots, pages, family="cross_polytope",
                           num_probes=4)
    assert a[2] is None and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cand = tref.probed_candidate_ids(slots, tl.probe_batch(q)).numpy()
    assert np.array_equal(b[2].numpy(), tops.unique_counts(cand))


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("D", [16, 30, 36, 64, 128, 256])
@pytest.mark.parametrize("B", [1, 1000, 1024, 4096])
def test_hash_plan_tiles_and_shared_memory(D, B):
    p = tlsh_k.launch_plan(B, D, 5)
    assert p["tile_rows"] in (16, 32, 64) and p["tile_rows"] == 16 * p["row_slots"]
    assert p["threads"] == 256 and p["slab"] == 16 * p["proj_per_lane"]
    assert p["proj_per_lane"] in (2, 4, 8) and p["slabs"] * p["slab"] >= D
    assert p["grid"] == (-(-B // p["tile_rows"]), 5) and p["grid"][0] * p["tile_rows"] >= B
    assert p["smem_bytes"] <= 232448
    if D <= 128:
        assert p["slabs"] == 1                            # a whole rotation at once
    if B >= 1000:
        assert p["grid"][0] * p["grid"][1] >= SMS         # the card is filled
        assert p["tile_rows"] == (64 if B == 4096 else 32)
        bigger = tlsh_k.launch_plan(B, D, 5)["tile_rows"] * 2
        assert bigger > 64 or -(-B // bigger) * 5 < SMS   # the largest that fills it


def test_hash_plan_at_the_serving_shapes():
    assert tlsh_k.launch_plan(1024, 64, 5)["grid"] == (32, 5)              # 160 blocks
    assert tlsh_k.launch_plan(4096, 64, 5)["grid"] == (64, 5)               # 320 blocks
    assert tlsh_k.launch_plan(1024, 128, 5)["smem_bytes"] == (32 + 128) * 132 * 4
    assert tlsh_k.launch_plan(4096, 128, 5)["smem_bytes"] == (64 + 128) * 132 * 4
    assert tlsh_k.launch_plan(200, 64, 5)["tile_rows"] == 16                # 65 blocks, not 35
    with pytest.raises(ValueError):
        tlsh_k.launch_plan(64, 512, 5)


@pytest.mark.parametrize("row_slots", [1, 2, 4])
def test_hash_plan_named_tile(row_slots):
    """A named tile keeps the plan's other shapes; an unknown one raises."""
    auto = tlsh_k.launch_plan(1024, 128, 5)
    p = tlsh_k.launch_plan(1024, 128, 5, row_slots=row_slots)
    assert p["tile_rows"] == 16 * row_slots and p["grid"] == (-(-1024 // p["tile_rows"]), 5)
    assert p["smem_bytes"] == (16 * row_slots + 128) * 132 * 4
    assert {k: p[k] for k in ("proj_per_lane", "slab", "slabs", "threads")} == \
        {k: auto[k] for k in ("proj_per_lane", "slab", "slabs", "threads")}
    with pytest.raises(ValueError):
        tlsh_k.launch_plan(1024, 128, 5, row_slots=3)


@pytest.mark.parametrize("D,fits", [(16, True), (30, True), (64, True), (128, True),
                                    (256, True), (300, False)])
def test_probed_plan_shared_memory(D, fits):
    """Dense blocks at D up to 256 fit beside their static slot ids."""
    if not fits:
        with pytest.raises(ValueError):
            ttopk.probed_plan(1024, 8, 256, D)
        return
    p = ttopk.probed_plan(1024, 8, 256, D)
    assert p["smem_bytes"] == (64 + 2 * 64) * (-(-D // 4) * 4 + 4) * 4
    assert p["smem_bytes"] + 4 * 64 <= build.SMEM_LIMIT
    assert ttopk.probed_plan(64, 8, 256, 128)["smem_bytes"] == 0     # sparse: none


@pytest.mark.parametrize("B,P,NB,sparse", [(1024, 8, 256, False), (4096, 8, 16384, True),
                                           (64, 8, 256, True), (256, 8, 256, False),
                                           (255, 8, 256, True)])
def test_probed_plan_block_shape(B, P, NB, sparse):
    """Dense blocks where a slot row expects 8 probers or more (the serving
    shape, ~64), sparse ones below (the store shape, ~2)."""
    p = ttopk.probed_plan(B, P, NB, 64)
    assert p["sparse"] == sparse
    assert p["threads"] == (64 if sparse else 256)
    assert p["smem_bytes"] == (0 if sparse else 192 * 68 * 4)
    # a row in a sparse block's registers: D % 4 == 0 and D <= 128, else dense
    for d, ok in ((128, True), (30, False), (132, False)):
        assert ttopk.probed_plan(B, P, NB, d)["sparse"] == (sparse and ok)
    # and 16-byte aligned rows: an unaligned view takes the dense blocks
    assert ttopk.probed_plan(B, P, NB, 64, aligned=False) == ttopk.dense_plan(64)
