"""Launch plans of the gathered and brute-force top-1 kernels, on the CPU.

The CUDA kernels run only on a card, but how they cut the work is Python:
``sim_topk.gather_plan`` splits K3's (and K1's id route's) candidate axis
over blocks and warps, ``sim_topk.sim_plan`` cuts K5's queries into tiles
and the store's valid rows into splits.  These tests hold the plans to what
the kernels assume: every candidate and every valid row is taken exactly
once, the grid fills the H100 at the shapes PERF.md measures, and a block's
shared memory fits.  They also emulate each plan's split and order-free
merge with the plain versions (``ref.gather_top1_ref``, ``ref.sim_top1_ref``)
a split at a time, and hold the merged result against the whole plain
version and against the Pallas ``gather_top1`` / ``sim_top1`` in interpret
mode.  Scores agree within 1e-5; ids are equal except where two candidates'
float64 scores are within 1e-5 of each other (as in test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sim_topk as jtopk
from repro_torch.core.lsh import normalize
from repro_torch.kernels import build, ref, sim_topk

SMS = 132        # H100 SXM
TOL = 1e-5
TIE = 1e-5


def _unit(rng, *shape):
    return normalize(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------ gather_plan
def _gather_coverage(b, c, plan):
    """How often the kernel's (split, warp, group, lane) indexing takes each
    candidate position of a row: split y covers [y * chunk, min(.., C)), warp
    w its groups w, w + warps, ... of ``group`` positions."""
    seen = np.zeros(c, int)
    warps, group = plan["threads"] // 32, plan["group"]
    for y in range(plan["splits"]):
        c0, c1 = y * plan["chunk"], min((y + 1) * plan["chunk"], c)
        n_groups = -(-(c1 - c0) // group) if c1 > c0 else 0
        for w in range(warps):
            for g in range(w, n_groups, warps):
                pos = c0 + g * group + np.arange(32)
                pos = pos[(np.arange(32) < group) & (pos < c1)]
                seen[pos] += 1
    return seen


@pytest.mark.parametrize("b,c,d", [(32, 16384, 64), (8, 16384, 64), (1, 16384, 64),
                                   (1024, 20480, 64), (1, 200, 64), (3, 5000, 30),
                                   (64, 511, 64), (64, 512, 64), (64, 513, 64),
                                   (2, 2049, 256), (4, 700, 1024), (5, 333, 4096)])
def test_gather_plan_takes_every_candidate_once(b, c, d):
    plan = sim_topk.gather_plan(b, c, d)
    assert (_gather_coverage(b, c, plan) == 1).all()
    assert plan["blocks"] == b * plan["splits"] and plan["splits"] >= 1
    # no split past the candidates
    assert (plan["splits"] - 1) * plan["chunk"] < max(c, 1)


@pytest.mark.parametrize("b,c", [(32, 16384), (1024, 20480)])   # PERF.md's K3 and K1 shapes
def test_gather_plan_fills_the_card(b, c):
    plan = sim_topk.gather_plan(b, c, 64)
    assert plan["blocks"] >= 2 * SMS
    assert sim_topk.GATHER_MIN_CHUNK <= plan["chunk"] <= sim_topk.GATHER_MAX_CHUNK
    assert plan["slots"] == 3 * SMS            # shared memory holds 3 blocks an SM at D=64
    # one wave of block slots where the chunk bounds allow it
    assert plan["blocks"] <= plan["slots"] or plan["chunk"] == sim_topk.GATHER_MAX_CHUNK


@pytest.mark.parametrize("b", [1, 8, 32])      # the staged path's batches
def test_gather_plan_spreads_small_batches(b):
    plan = sim_topk.gather_plan(b, 16384, 64)
    assert plan["splits"] >= 8 and plan["blocks"] > 1
    assert plan["blocks"] >= min(2 * SMS, b * 16384 // sim_topk.GATHER_MIN_CHUNK)


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_plan_shared_memory_fits(aligned):
    for d in list(range(1, 130)) + [255, 256, 257, 512, 896, 1000, 1024, 4096, 8192]:
        plan = sim_topk.gather_plan(4, 5000, d, aligned)
        ld = d + 4 if d % 4 == 0 and aligned else d | 1
        warps = plan["threads"] // 32
        assert plan["smem_bytes"] == 4 * (-(-d // 4) * 4 + warps * 2 * plan["group"] * ld)
        assert plan["smem_bytes"] <= build.SMEM_LIMIT
        assert 1 <= warps <= sim_topk.GATHER_WARPS and 1 <= plan["group"] <= 32
        assert plan["chunk"] % (warps * plan["group"]) == 0
    assert sim_topk.gather_plan(4, 5000, 64)["group"] == 32
    assert sim_topk.gather_plan(4, 5000, 64)["threads"] == 32 * sim_topk.GATHER_WARPS


def test_gather_plan_forced_chunk():
    plan = sim_topk.gather_plan(32, 16384, 64, chunk=2048)
    assert plan["chunk"] == 2048 and plan["splits"] == 8
    assert (_gather_coverage(32, 16384, plan) == 1).all()


# --------------------------------------------------------------- sim_plan
@pytest.mark.parametrize("q,n,d", [(4096, 249000, 64), (1, 249000, 64), (8, 64, 32),
                                   (130, 1000, 64), (300, 20000, 64), (5, 4096, 128),
                                   (64, 200, 256), (4096, 249000, 256), (200, 5000, 512),
                                   (129, 128, 64), (129, 129, 64), (7, 1023, 64),
                                   (7, 1025, 64), (10, 0, 64)])
def test_sim_plan_takes_every_row_once(q, n, d):
    plan = sim_topk.sim_plan(q, n, d)
    assert plan["chunk"] % sim_topk.SIM_TILE_ROWS == 0
    seen = np.zeros(max(n, 1), int)
    for y in range(plan["splits"]):
        lo, hi = y * plan["chunk"], min((y + 1) * plan["chunk"], n)
        assert lo < max(n, 1)                          # no empty split
        seen[lo:hi] += 1
    assert n == 0 or (seen == 1).all()
    # the query tiles hold Q, and no more than one tile too many
    assert plan["q_tiles"] * plan["q_rows"] >= q > (plan["q_tiles"] - 1) * plan["q_rows"]
    assert plan["blocks"] == plan["q_tiles"] * plan["splits"]


def test_sim_plan_fills_the_card_in_whole_waves():
    plan = sim_topk.sim_plan(4096, 249000, 64)   # PERF.md's K5 shape
    assert plan["q_rows"] == 128 and plan["slots"] == 2 * SMS
    assert plan["blocks"] >= 2 * SMS
    waves = -(-plan["blocks"] // plan["slots"])
    assert plan["blocks"] / (waves * plan["slots"]) >= sim_topk.SIM_WAVE_FILL


@pytest.mark.parametrize("q,rows", [(1, 16), (8, 16), (16, 16), (17, 32), (33, 64),
                                    (64, 64), (65, 128), (4096, 128)])
def test_sim_plan_small_query_tiles(q, rows):
    assert sim_topk.sim_plan(q, 100000, 64)["q_rows"] == rows


def test_sim_plan_shared_memory_fits():
    for d in range(4, 2049, 4):
        for q in (1, 100, 4096):
            plan = sim_topk.sim_plan(q, 50000, d)
            assert plan["smem_bytes"] == sim_topk.sim_smem(plan["q_rows"], d)
            assert plan["smem_bytes"] + 4 * plan["q_rows"] <= build.SMEM_LIMIT
    assert sim_topk.sim_plan(4096, 50000, 256)["q_rows"] == 128   # the card tests' widest D


# ---------------------------------------- emulated split and merge vs whole
def _merge(parts):
    """Order-free lexicographic (max score, min key) merge of per-split
    (score, key) arrays; a -inf score is no candidate."""
    val = np.full(parts[0][0].shape, -np.inf, np.float32)
    key = np.full(parts[0][0].shape, np.iinfo(np.int64).max, np.int64)
    for v, k in parts:
        better = (v > val) | ((v == val) & (k < key) & np.isfinite(v))
        val, key = np.where(better, v, val), np.where(better, k, key)
    return val, key


def _agree(q, rows, got, want):
    """Scores within TOL; ids equal except at float64 near-ties."""
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    fin = np.isfinite(wv)
    assert (np.isfinite(gv) == fin).all()
    if fin.any():
        assert np.abs(gv[fin] - wv[fin]).max() <= TOL
    for r in np.flatnonzero(gi != wi):
        s = rows[[gi[r], wi[r]]].astype(np.float64) @ q[r].astype(np.float64)
        assert abs(s[0] - s[1]) < TIE, (r, gi[r], wi[r])


def _sorted_ids(rng, b, n, c):
    """(b, c) front-packed ascending unique ids, -1 padded; row 0 empty."""
    ids = np.full((b, c), -1, np.int32)
    for r in range(1, b):
        k = int(rng.integers(1, c + 1))
        ids[r, :k] = np.sort(rng.choice(n, min(k, n), replace=False))[:k]
    return ids


def _emulate_gather(q, store, ids, plan, by_position):
    """The kernel's split and merge with the plain version a split at a time:
    each split's best (by position, or by id), merged order-free."""
    parts = []
    for y in range(plan["splits"]):
        sl = ids[:, y * plan["chunk"]:(y + 1) * plan["chunk"]]
        if sl.shape[1] == 0:
            continue
        fn = ref.gather_top1_ref if by_position else ref.reuse_top1_ref
        v, i = (x.numpy() for x in fn(torch.from_numpy(q), torch.from_numpy(store),
                                      torch.from_numpy(np.ascontiguousarray(sl))))
        if by_position:   # the key is the candidate's position in the whole row
            pos = np.array([y * plan["chunk"] + (int(np.flatnonzero(sl[r] == i[r])[0])
                                                 if i[r] >= 0 else 0) for r in range(len(i))])
            parts.append((v, pos))
        else:
            parts.append((v, i.astype(np.int64)))
    val, key = _merge(parts)
    if by_position:
        idx = np.where(np.isfinite(val), ids[np.arange(len(val)), np.minimum(key, ids.shape[1] - 1)], -1)
    else:
        idx = np.where(np.isfinite(val), key, -1)
    return val, idx.astype(np.int32)


@pytest.mark.parametrize("b,n,c,d,chunk", [(8, 3000, 1100, 32, None), (5, 2000, 700, 16, 256),
                                           (3, 500, 300, 30, 128), (4, 4096, 2048, 64, 512)])
def test_gather_split_merge_equals_whole_and_pallas(b, n, c, d, chunk):
    rng = np.random.default_rng(b * c + d)
    q, store = _unit(rng, b, d), _unit(rng, n, d)
    ids = _sorted_ids(rng, b, n, c)
    ids[1] = np.sort(rng.choice(n, c, replace=False))   # a full row: a tie between
    store[ids[1, -1]] = store[ids[1, 0]]                 # its first and last split
    q[1] = store[ids[1, 0]]
    plan = sim_topk.gather_plan(b, c, d, chunk=chunk)
    assert plan["splits"] > 1
    got = _emulate_gather(q, store, ids, plan, by_position=True)
    whole = sim_topk.gather_top1(torch.from_numpy(q), torch.from_numpy(store),
                                 torch.from_numpy(ids))
    _agree(q, store, got, whole)
    assert got[1][1] == whole[1][1].item() == ids[1, 0] and got[1][0] == -1
    pal = jtopk.gather_top1(jnp.asarray(q), jnp.asarray(store), jnp.asarray(ids))
    _agree(q, store, got, (np.asarray(pal[0]), np.asarray(pal[1])))


@pytest.mark.parametrize("b,n,c,d,chunk", [(8, 3000, 1100, 32, None), (6, 400, 900, 16, 256)])
def test_reuse_id_route_split_merge_equals_whole(b, n, c, d, chunk):
    """K1's id route under gather_plan: raw ids with duplicates and -1 slots,
    the lowest id among equal rows in different splits wins."""
    rng = np.random.default_rng(c + d)
    q, store = _unit(rng, b, d), _unit(rng, n, d)
    store[n - 1] = store[5]
    q[0] = store[5]
    ids = rng.integers(-1, n, (b, c)).astype(np.int32)
    ids[0, 0], ids[0, -1] = n - 1, 5              # the tie, in the first and last split
    ids[1] = -1
    plan = sim_topk.gather_plan(b, c, d, chunk=chunk)
    assert plan["splits"] > 1
    got = _emulate_gather(q, store, ids, plan, by_position=False)
    whole = sim_topk.reuse_top1(torch.from_numpy(q), torch.from_numpy(store),
                                torch.from_numpy(ids))
    _agree(q, store, got, whole)
    assert got[1][0] == 5 and got[1][1] == -1


def _emulate_sim(q, store, n_valid, plan):
    parts = []
    for y in range(plan["splits"]):
        lo, hi = y * plan["chunk"], min((y + 1) * plan["chunk"], n_valid)
        if hi <= lo:
            continue
        v, i = ref.sim_top1_ref(torch.from_numpy(q), torch.from_numpy(store[lo:hi]))
        parts.append((v.numpy(), i.numpy().astype(np.int64) + lo))
    if not parts:
        return np.full(len(q), -np.inf, np.float32), np.zeros(len(q), np.int32)
    val, key = _merge(parts)
    return val, np.where(np.isfinite(val), key, 0).astype(np.int32)


@pytest.mark.parametrize("q_n,n,n_valid,d", [(8, 3000, 3000, 32), (20, 5000, 4097, 16),
                                             (130, 2100, 2048, 32), (3, 2500, 1025, 64),
                                             (4, 300, 0, 16)])
def test_sim_split_merge_equals_whole_and_pallas(q_n, n, n_valid, d):
    rng = np.random.default_rng(q_n + n + d)
    q, store = _unit(rng, q_n, d), _unit(rng, n, d)
    if n_valid > 1500:
        store[n_valid - 1] = store[3]             # a tie across splits: index 3 wins
        q[0] = store[3]
    plan = sim_topk.sim_plan(q_n, n_valid, d)
    assert n_valid < 2 * sim_topk.SIM_MIN_SPLIT_ROWS or plan["splits"] > 1
    got = _emulate_sim(q, store, n_valid, plan)
    whole = sim_topk.sim_top1(torch.from_numpy(q), torch.from_numpy(store), n_valid)
    _agree(q, store, got, whole)
    if n_valid == 0:
        assert np.isneginf(got[0]).all() and (got[1] == 0).all()
        assert torch.isneginf(whole[0]).all() and (whole[1] == 0).all()
        return
    if n_valid > 1500:
        assert got[1][0] == 3
    pal = jtopk.sim_top1(jnp.asarray(q), jnp.asarray(store), n_valid)
    _agree(q, store, got, (np.asarray(pal[0]), np.asarray(pal[1])))
