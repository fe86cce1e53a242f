"""Each hand-written CUDA kernel against its plain PyTorch version, on a card.

Marked ``cuda``: without a CUDA card and ``nvcc`` every test skips.  The
file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Ids must be equal (the inputs hold no float near-ties except the planted
exact ones); scores agree within 1e-5 (fp32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lsh import LSH, LSHParams, normalize
from repro_torch.kernels import lsh_hash, ref, sim_topk

RNG = np.random.default_rng(0)
TOL = 1e-5


def _unit(*shape):
    return torch.from_numpy(normalize(RNG.standard_normal(shape).astype(np.float32)))


@pytest.fixture
def dev():
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _same(got, want):
    gv, gi = (t.cpu() for t in got)
    wv, wi = (t.cpu() for t in want)
    assert torch.equal(gi, wi)
    fin = torch.isfinite(wv)
    assert torch.equal(torch.isfinite(gv), fin)
    assert (gv[fin] - wv[fin]).abs().max().item() <= TOL


@pytest.mark.cuda
def test_reuse_top1(dev):
    q, s = _unit(64, 64), _unit(5000, 64)
    s[4000] = s[7]
    q[0] = s[7]
    ids = torch.from_numpy(RNG.integers(-1, 5000, (64, 640)).astype(np.int32))
    ids[0, :2] = torch.tensor([4000, 7])
    ids[1] = -1
    args = [q.to(dev), s.reshape(50, 100, 64).to(dev), ids.to(dev)]
    got = sim_topk.reuse_top1(*args)
    _same(got, ref.reuse_top1_ref(*args))
    assert got[1][0].item() == 7 and got[1][1].item() == -1
    flat = sim_topk.reuse_top1(args[0], s.to(dev), args[2])
    _same(flat, got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 30])   # 16-byte row loads, and scalar ones
def test_gather_top1(dev, D):
    q, s = _unit(32, D), _unit(5000, D)
    ids = torch.full((32, 512), -1, dtype=torch.int32)
    for r in range(1, 32):
        k = int(RNG.integers(1, 513))
        ids[r, :k] = torch.from_numpy(np.sort(RNG.choice(5000, k, replace=False)).astype(np.int32))
    args = [q.to(dev), s.to(dev), ids.to(dev)]
    _same(sim_topk.gather_top1(*args), ref.gather_top1_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("D,K", [(64, 1), (128, 2), (36, 1)])
def test_lsh_hash(dev, D, K):
    t = LSH(LSHParams(dim=D, num_tables=5, rotations_per_table=K), dev)
    x = _unit(1000, D).to(dev)
    mixed = lsh_hash.lsh_hash_mix(x, t.rotations, 256)
    # a vertex may differ only at an fp32 near-tie of two coordinates
    assert (mixed == ref.lsh_hash_mix_ref(x, t.rotations, 256)).float().mean().item() > 0.999
    vids = lsh_hash.lsh_hash(x, t.rotations)
    assert (vids == ref.lsh_hash_ref(x, t.rotations)).float().mean().item() > 0.999


@pytest.mark.cuda
def test_wrappers_count_launches_and_raise(dev):
    q, s = _unit(4, 64).to(dev), _unit(100, 64).to(dev)
    ids = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    n0 = sim_topk.LAUNCHES["reuse_top1"]
    sim_topk.reuse_top1(q, s, ids)
    assert sim_topk.LAUNCHES["reuse_top1"] == n0 + 1
    with pytest.raises(ValueError):
        sim_topk.reuse_top1(q, s.cpu(), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])   # "high" turns TF32 on
@pytest.mark.parametrize("D,K", [(64, 1), (32, 2)])
def test_probe_zero_is_kernel_hash(dev, precision, D, K):
    """Probe 0 (plain torch einsum) is the kernel's hash, even with TF32 on
    for the process, except where two vertex scores tie in float64."""
    t = LSH(LSHParams(dim=D, num_tables=5, rotations_per_table=K, num_probes=8), dev)
    x = _unit(4096, D)
    torch.set_float32_matmul_precision(precision)
    try:
        probe0 = t.probe_batch(x)[..., 0].cpu().numpy()
        hashed = t.hash_batch(x).cpu().numpy()
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision("highest")
    proj = np.einsum("tkde,be->btkd", t.rotations.cpu().double().numpy(), x.double().numpy())
    srt = np.sort(np.concatenate([proj, -proj], axis=-1), axis=-1)
    near = ((srt[..., -1] - srt[..., -2]) < 1e-5).any(axis=-1)    # (B, T)
    assert not ((probe0 != hashed) & ~near).any()


@pytest.mark.cuda
def test_small_staged_batches_score_on_the_card(dev):
    """On a CUDA store, staged batches and scalar queries take the
    reference's route: below use_kernel_threshold they score on the host
    (no gather_top1 launch) and equal a CPU store fed the same inserts bit
    for bit; a batch whose gather work reaches the threshold launches
    gather_top1 once and agrees with the CPU store within TOL."""
    from repro_torch.core.reuse_store import ReuseStore

    p = LSHParams(dim=32, num_tables=3, num_probes=4, seed=5)
    x = normalize(RNG.standard_normal((300, 32)).astype(np.float32))
    q = normalize(x[:4] + 0.01 * RNG.standard_normal((4, 32)).astype(np.float32))
    stores = [ReuseStore(p, capacity=512, device=d) for d in (dev, "cpu")]
    for s in stores:
        s.insert_batch(x, list(range(300)))
    n0 = sim_topk.LAUNCHES["gather_top1"]
    gpu, cpu = (s.query_batch(q, 0.5, peek=True) for s in stores)
    one, one_cpu = (s.query(q[0], 0.5) for s in stores)
    assert sim_topk.LAUNCHES["gather_top1"] == n0
    assert gpu == cpu and one == one_cpu and one[2] == gpu[0][2]
    for s in stores:
        s.use_kernel_threshold = 1
    gpu, cpu = (s.query_batch(q, 0.5, peek=True) for s in stores)
    assert sim_topk.LAUNCHES["gather_top1"] == n0 + 1
    assert [r[2] for r in gpu] == [r[2] for r in cpu]
    assert max(abs(a[1] - b[1]) for a, b in zip(gpu, cpu)) <= TOL


# ------------------------------------------------- sim_top1 and attention
def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,D", [(8, 64, 32), (128, 1000, 64), (5, 4096, 128),
                                   (64, 200, 256), (300, 20000, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sim_top1(dev, Q, N, D, dtype):
    q, s = _unit(Q, D).to(dtype), _unit(N, D).to(dtype)
    q[0] = s[N // 2]                                  # an exact hit
    if N > 100:
        s[N - 1] = s[N // 3]                          # a tie: the first index wins
        q[1] = s[N // 3]
    n0 = sim_topk.LAUNCHES["sim_top1"]
    gv, gi = sim_topk.sim_top1(q.to(dev), s.to(dev))
    assert sim_topk.LAUNCHES["sim_top1"] == n0 + 1
    wv, wi = ref.sim_top1_ref(q.to(dev), s.to(dev))
    tol = TOL if dtype == torch.float32 else 2e-2
    _close(gv, wv, tol)
    if dtype == torch.float32:
        assert torch.equal(gi.cpu(), wi.cpu())
    assert gi[0].item() == N // 2
    if N > 100:
        assert gi[1].item() == N // 3


@pytest.mark.cuda
def test_sim_top1_n_valid(dev):
    q, s = _unit(16, 64).to(dev), _unit(512, 64).to(dev)
    gv, gi = sim_topk.sim_top1(q, s, 100)
    wv, wi = ref.sim_top1_ref(q, s, 100)
    assert (gi < 100).all() and torch.equal(gi.cpu(), wi.cpu())
    _close(gv, wv, TOL)
    ev, ei = sim_topk.sim_top1(q, s, 0)             # nothing valid: (-inf, 0)
    assert torch.isinf(ev).all() and (ei == 0).all()


def _qkv(B, S, T, H, KV, D, dtype):
    mk = lambda *shape: torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dtype)
    return mk(B, S, H, D), mk(B, T, KV, D), mk(B, T, KV, D)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", [(1, 32, 4, 4, 32), (2, 64, 8, 2, 64),
                                        (1, 128, 8, 1, 128), (2, 48, 4, 4, 16),
                                        (1, 200, 16, 8, 128), (1, 70, 4, 2, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, B, S, H, KV, D, dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(B, S, S, H, KV, D, dtype))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == n0 + 1 and got.dtype == dtype
    _close(got, ref.flash_attention_ref(q, k, v), 2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [{"causal": False}, {"causal": True, "window": 16},
                                    {"causal": True, "softcap": 50.0},
                                    {"causal": True, "window": 24, "softcap": 30.0},
                                    {"causal": True, "scale": 0.0625}])
def test_flash_attention_variants(dev, kwargs):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, 100, 100, 8, 4, 32, torch.float32))
    _close(fa.flash_attention(q, k, v, **kwargs), ref.flash_attention_ref(q, k, v, **kwargs),
           2e-5)


@pytest.mark.cuda
def test_flash_attention_cross_and_masked_rows(dev):
    """T != S without a causal mask; and rows whose every key is masked
    (window past the end of a short key axis) give 0, not NaN."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, 40, 72, 4, 2, 64, torch.float32))
    _close(fa.flash_attention(q, k, v, causal=False),
           ref.flash_attention_ref(q, k, v, causal=False), 2e-5)
    q, k, v = (x.to(dev) for x in _qkv(1, 48, 16, 4, 4, 32, torch.bfloat16))
    got = fa.flash_attention(q, k, v, window=8)
    assert torch.isfinite(got.float()).all() and (got[:, 24:] == 0).all()
    _close(got, ref.flash_attention_ref(q, k, v, window=8), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 112])
@pytest.mark.parametrize("S,T,H,KV,kwargs", [(333, 333, 8, 8, {}),
                                             (100, 180, 16, 8, {"causal": False}),
                                             (257, 257, 8, 4, {"window": 64, "softcap": 30.0})])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_padded_widths(dev, D, S, T, H, KV, kwargs, dtype):
    """Head widths 96 (phi-3-vision) and 112 (zamba2) on both routes: the
    bf16 route's tiles are 128 columns, TMA filling the columns past D."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, S, T, H, KV, D, dtype))
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kwargs)
    assert fa.LAUNCHES["flash_attention"] == n0 + 1 and got.shape == (2, S, H, D)
    _close(got, ref.flash_attention_ref(q, k, v, **kwargs),
           2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D", [(1, 64, 4, 4, 32), (2, 96, 8, 2, 64),
                                        (2, 1600, 32, 32, 112), (2, 2200, 32, 32, 96),
                                        (4, 128, 8, 1, 128), (4, 2064, 16, 8, 128),
                                        (2, 2567, 40, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention(dev, B, T, H, KV, D, dtype):
    from repro_torch.kernels import decode_attention as da

    q, k, v = (x.to(dev) for x in _qkv(B, 1, T, H, KV, D, dtype))
    q = q[:, 0]
    kv_len = torch.from_numpy(RNG.integers(1, T + 1, B).astype(np.int32)).to(dev)
    kv_len[0] = 1
    n0 = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(q, k, v, kv_len)
    assert da.LAUNCHES["decode_attention"] == n0 + 1 and got.dtype == dtype
    _close(got, ref.decode_attention_ref(q, k, v, kv_len),
           2e-5 if dtype == torch.float32 else 2e-2)
    # f32 query over a bf16 cache, with a softcap
    got = da.decode_attention(q.float(), k.to(torch.bfloat16), v.to(torch.bfloat16), kv_len,
                              softcap=30.0)
    want = ref.decode_attention_ref(q.float(), k.to(torch.bfloat16), v.to(torch.bfloat16),
                                    kv_len, softcap=30.0)
    _close(got, want, 2e-5)


@pytest.mark.cuda
def test_decode_equals_flash_last_row_and_empty_rows(dev):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, 48, 48, 4, 2, 32, torch.float32))
    full = fa.flash_attention(q, k, v)
    got = da.decode_attention(q[:, -1], k, v, torch.tensor([48, 48], dtype=torch.int32,
                                                           device=dev))
    _close(got, full[:, -1], 2e-5)
    zero = da.decode_attention(q[:, -1], k, v, torch.zeros(2, dtype=torch.int32, device=dev))
    assert (zero == 0).all()


@pytest.mark.cuda
def test_attention_wrappers_raise_on_mixed_devices(dev):
    from repro_torch.kernels import ops

    q, k, v = _qkv(1, 16, 16, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError):
        ops.flash_attention(q.to(dev), k, v)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0].to(dev), k.to(dev), v.to(dev),
                             torch.ones(1, dtype=torch.int32))


# ------------------------------------ K6 bf16 on the tensor cores, K7 split
def _bf16_close(got, want, tol=1e-3):
    """bf16 outputs: within ``tol`` plus one bf16 ulp of the plain value
    (both round an fp32 result summed in another order)."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bad = (g - w).abs() > tol + w.abs() * 2.0 ** -7
    assert not bad.any(), f"{int(bad.sum())} off, max {(g - w).abs().max().item():.3g}"


def _flash_bf16(dev, B, S, T, H, KV, D, **kw):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(B, S, T, H, KV, D, torch.bfloat16))
    assert fa.launch_plan(q.dtype, B, S, T, H, KV, D)["route"] == "wgmma"
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES["flash_attention"] == n0 + 1 and got.dtype == torch.bfloat16
    _bf16_close(got, ref.flash_attention_ref(q, k, v, **kw))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_flash_attention_bf16_widths_and_groups(dev, D, G):
    _flash_bf16(dev, 2, 150, 150, 2 * G, 2, D)


@pytest.mark.cuda
@pytest.mark.parametrize("S,G,D", [(333, 2, 128), (1000, 2, 128), (1000, 5, 64),
                                   (333, 8, 256)])
def test_flash_attention_bf16_ragged(dev, S, G, D):
    """S = T a multiple of no tile, and G = 5 (60 of a warpgroup's 64 rows)."""
    _flash_bf16(dev, 1, S, S, G, 1, D)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"window": 64}, {"softcap": 30.0},
                                {"window": 100, "softcap": 50.0}, {"scale": 0.0625}])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bf16_window_softcap(dev, kw, D):
    _flash_bf16(dev, 2, 300, 300, 8, 4, D, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(100, 180), (180, 100), (64, 1)])
def test_flash_attention_bf16_cross(dev, S, T):
    _flash_bf16(dev, 2, S, T, 16, 8, 128, causal=False)


@pytest.mark.cuda
def test_flash_attention_bf16_rows_without_a_key(dev):
    got = _flash_bf16(dev, 1, 48, 16, 4, 4, 32, window=8)
    assert (got[:, 24:] == 0).all()
    got = _flash_bf16(dev, 1, 300, 70, 8, 2, 128, window=16)
    assert (got[:, 86:] == 0).all()


@pytest.mark.cuda
def test_flash_attention_bf16_long(dev):
    """S = T = 4096: 64 laps of each warpgroup's key ring at the last rows, so
    a slip in the barriers' phase bits shows."""
    _flash_bf16(dev, 1, 4096, 4096, 16, 8, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 128, 256])
def test_flash_attention_f32_keeps_the_cuda_core_kernel(dev, D):
    """f32 takes the CUDA-core route and holds 2e-5 (TF32 products would not)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, 200, 200, 8, 2, D, torch.float32))
    assert fa.launch_plan(q.dtype, 2, 200, 200, 8, 2, D)["route"] == "fma"
    n0 = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, window=50)
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    _close(got, ref.flash_attention_ref(q, k, v, window=50), 2e-5)


def _decode_lens(B, T, KV, G, D):
    """kv_len at the split boundaries of the plan (chunk - 1, chunk,
    chunk + 1 of a full row's chunk) and at 0, 1 and T."""
    from repro_torch.kernels import decode_attention as da

    n = da.split_plan(B, KV, T, G, D, 2)["n_split"]
    c = da.row_chunk(T, n)
    return [min(T, x) for x in (c - 1, c, c + 1, 0, 1, T)]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 5, 8])
@pytest.mark.parametrize("T,D", [(2064, 128), (300, 256), (500, 64)])
def test_decode_attention_split_boundaries(dev, G, T, D):
    from repro_torch.kernels import decode_attention as da

    lens = _decode_lens(6, T, 2, G, D)
    q, k, v = (x.to(dev) for x in _qkv(6, 1, T, 2 * G, 2, D, torch.bfloat16))
    q = q[:, 0]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(q, k, v, kv_len)
    assert da.LAUNCHES["decode_attention"] == n0 + 1
    _bf16_close(got, ref.decode_attention_ref(q, k, v, kv_len))
    assert (got[3] == 0).all()                     # kv_len = 0


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 8])
def test_decode_attention_f32_query_bf16_cache_softcap(dev, G):
    from repro_torch.kernels import decode_attention as da

    T, D = 700, 128
    q, k, v = _qkv(6, 1, T, 2 * G, 2, D, torch.float32)
    q, k, v = q[:, 0].to(dev), k.to(torch.bfloat16).to(dev), v.to(torch.bfloat16).to(dev)
    kv_len = torch.tensor(_decode_lens(6, T, 2, G, D), dtype=torch.int32, device=dev)
    got = da.decode_attention(q, k, v, kv_len, softcap=30.0)
    _close(got, ref.decode_attention_ref(q, k, v, kv_len, softcap=30.0), 2e-5)


# ------------------------------------- K1 bucket-major route, K4 register tiles
def _probed_inputs(B, T, P, NB, cap, N, D, seed):
    """Slot tables with duplicates, -1 slots, equal rows and a query whose
    probed buckets hold no id; buckets with some left unprobed."""
    rng = np.random.default_rng(seed)
    s = normalize(rng.standard_normal((N, D)).astype(np.float32))
    s[N - 1] = s[3]                                  # equal rows: 3 must win
    slots = rng.integers(0, N, (T * NB, cap)).astype(np.int32)
    slots[rng.random(slots.shape) < 0.2] = -1
    slots[:, 1] = slots[:, 0]                        # a duplicate in every bucket
    slots[NB - 1] = -1                               # table 0's last bucket is empty
    buckets = rng.integers(0, NB // 2, (B, T, P)).astype(np.int32)   # upper half unprobed
    buckets[1] = NB - 1                              # query 1 probes only empty rows ...
    buckets[1, 1:] = NB // 2 + 1                     # ... and unprobed-by-others ones
    slots[NB + NB // 2 + 1 :: NB] = -1               # that also hold nothing
    slots[NB // 2 + 1] = -1
    slots[0, :2] = [N - 1, 3]                        # query 0: the tie across rows
    buckets[0, :, 0] = 0
    buckets[0, 1:, 0] = NB // 2 - 1
    q = normalize(rng.standard_normal((B, D)).astype(np.float32))
    q[0] = s[3]
    return (torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(slots),
            torch.from_numpy(buckets))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,P,NB,cap,N,D", [
    (300, 2, 3, 16, 100, 5000, 64),       # dense blocks, ~110 probers a row: two chunks
    (1024, 5, 8, 256, 130, 20000, 64),    # the serving shape, cap past two row tiles
    (64, 5, 8, 512, 62, 3000, 64),        # sparse blocks, ~2 probers a row
    (40, 3, 4, 32, 70, 900, 30),          # few probers but D % 4 != 0: dense, 4-byte copies
    (400, 2, 4, 16, 100, 5000, 30),       # dense, D % 4 != 0, two chunks
    (40, 3, 4, 32, 70, 900, 96),          # sparse, D = 96: a row of 24 vectors
    (8, 2, 2, 8, 64, 200, 128)])          # sparse, D = 128
@pytest.mark.parametrize("paged", [True, False])
def test_reuse_top1_probed_matches_id_route(dev, B, T, P, NB, cap, N, D, paged):
    q, s, slots, buckets = _probed_inputs(B, T, P, NB, cap, N, D, seed=B + D)
    store = s.reshape(N // 100, 100, D) if paged and N % 100 == 0 else s
    args = [q.to(dev), store.to(dev), slots.to(dev), buckets.to(dev)]
    n0 = sim_topk.LAUNCHES["reuse_top1_probed"]
    gv, gi = sim_topk.reuse_top1_probed(*args)
    assert sim_topk.LAUNCHES["reuse_top1_probed"] == n0 + 1
    ids = ref.probed_candidate_ids(args[2], args[3]).contiguous()
    wv, wi = sim_topk.reuse_top1(args[0], args[1], ids)
    assert torch.equal(gi.cpu(), wi.cpu()) and torch.equal(gv.cpu(), wv.cpu())
    _same((gv, gi), ref.reuse_top1_probed_ref(*args))
    assert gi[0].item() == 3 and gi[1].item() == -1 and torch.isneginf(gv[1]).item()


@pytest.mark.cuda
def test_reuse_top1_probed_raises_on_mixed_devices(dev):
    q, s, slots, buckets = _probed_inputs(8, 2, 2, 8, 64, 200, 64, seed=1)
    with pytest.raises(ValueError):
        sim_topk.reuse_top1_probed(q.to(dev), s.to(dev), slots, buckets.to(dev))
    with pytest.raises(TypeError):
        sim_topk.reuse_top1_probed(q.to(dev), s.to(dev), slots.long().to(dev),
                                   buckets.to(dev))


def _near_ties(x, rot):
    """(B, T, K) float64 vertex margins below 1e-5 (where fp32 sums in another
    order may pick another vertex)."""
    proj = np.einsum("tkde,be->btkd", rot.double().numpy(), x.double().numpy())
    srt = np.sort(np.concatenate([proj, -proj], axis=-1), axis=-1)
    return (srt[..., -1] - srt[..., -2]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("D,K", [(64, 1), (128, 2), (32, 3)])
@pytest.mark.parametrize("B", [1, 1000, 4096])
def test_lsh_hash_register_tiled(dev, D, K, B):
    rng = np.random.default_rng(D * K + B)
    t = LSH(LSHParams(dim=D, num_tables=5, rotations_per_table=K, seed=B), dev)
    x = torch.from_numpy(normalize(rng.standard_normal((B, D)).astype(np.float32)))
    near = _near_ties(x, t.rotations.cpu())
    xd = x.to(dev)
    vids = lsh_hash.lsh_hash(xd, t.rotations).cpu()
    assert not ((vids != ref.lsh_hash_ref(xd, t.rotations).cpu()) & torch.from_numpy(~near)).any()
    mixed = lsh_hash.lsh_hash_mix(xd, t.rotations, 256).cpu()
    want = ref.lsh_hash_mix_ref(xd, t.rotations, 256).cpu()
    assert not ((mixed != want) & torch.from_numpy(~near.any(-1))).any()
    # planted exact +/- ties: signed permutations make every projection exact
    perm = np.stack([np.stack([np.eye(D, dtype=np.float32)[rng.permutation(D)]
                               * rng.choice([-1.0, 1.0], (D, 1)).astype(np.float32)
                               for _ in range(K)]) for _ in range(5)])
    rot = torch.from_numpy(np.ascontiguousarray(perm))
    xt = rng.standard_normal((B, D)).astype(np.float32) * 0.1
    a, b = rng.integers(0, D, B), rng.integers(0, D, B)
    xt[np.arange(B), a] = 1.0
    xt[np.arange(B), b] = np.where(rng.random(B) < 0.5, 1.0, -1.0)   # +/- ties with a
    xt = torch.from_numpy(xt)
    got = lsh_hash.lsh_hash(xt.to(dev), rot.to(dev)).cpu()
    assert torch.equal(got, ref.lsh_hash_ref(xt, rot))
    got = lsh_hash.lsh_hash_mix(xt.to(dev), rot.to(dev), 1 << 20).cpu()
    assert torch.equal(got, ref.lsh_hash_mix_ref(xt, rot, 1 << 20))


def _offset_view(x, shift=1):
    """A contiguous copy of ``x`` whose storage starts ``shift`` floats past a
    16-byte boundary (a view into a larger buffer)."""
    buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    view = buf[shift:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB", [(1024, 256), (64, 512)])      # dense, sparse plans
def test_reuse_top1_probed_unaligned_views(dev, B, NB):
    q, s, slots, buckets = _probed_inputs(B, 5, 8, NB, 70, 5000, 64, seed=B)
    args = [q.to(dev), s.reshape(50, 100, 64).to(dev), slots.to(dev), buckets.to(dev)]
    want = sim_topk.reuse_top1_probed(*args)
    for i in (0, 1):          # q, then the store, off a 16-byte boundary
        moved = list(args)
        moved[i] = _offset_view(args[i])
        got = sim_topk.reuse_top1_probed(*moved)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_lsh_hash_unaligned_views(dev):
    rng = np.random.default_rng(3)
    t = LSH(LSHParams(dim=64, num_tables=5, rotations_per_table=2, seed=3), dev)
    x = torch.from_numpy(normalize(rng.standard_normal((1000, 64)).astype(np.float32))).to(dev)
    want = lsh_hash.lsh_hash_mix(x, t.rotations, 256)
    assert torch.equal(lsh_hash.lsh_hash_mix(_offset_view(x), t.rotations, 256), want)
    assert torch.equal(lsh_hash.lsh_hash_mix(x, _offset_view(t.rotations), 256), want)
    assert torch.equal(lsh_hash.lsh_hash(_offset_view(x), t.rotations),
                       lsh_hash.lsh_hash(x, t.rotations))


@pytest.mark.cuda
@pytest.mark.parametrize("row_slots", [1, 2, 4])
def test_lsh_hash_every_tile_gives_the_same_ids(dev, row_slots):
    rng = np.random.default_rng(row_slots)
    t = LSH(LSHParams(dim=128, num_tables=5, rotations_per_table=2, seed=4), dev)
    x = torch.from_numpy(normalize(rng.standard_normal((1000, 128)).astype(np.float32))).to(dev)
    out = torch.empty(1000, 5, dtype=torch.int32, device=dev)
    plan = lsh_hash.launch_plan(1000, 128, 5, row_slots=row_slots)
    lsh_hash.launch("lsh_hash_mix_launch", x, t.rotations, out, 256, plan=plan)
    assert torch.equal(out, lsh_hash.lsh_hash_mix(x, t.rotations, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["cross_polytope", "hyperplane"])
def test_fused_counts_on_the_card(dev, family):
    """The count epilogue's sort on the card against the host count of the
    same id matrix, with duplicates and -1 slots."""
    from repro_torch.kernels import ops

    kw = dict(dim=32, num_tables=3, num_probes=4, num_buckets=64, seed=6, family=family)
    lsh = LSH(LSHParams(**kw), dev)
    rng = np.random.default_rng(6)
    slots = rng.integers(-1, 400, (3 * 64, 40)).astype(np.int32)
    slots[:, 1] = slots[:, 0]
    slots[rng.random(slots.shape) < 0.3] = -1
    slots = torch.from_numpy(slots).to(dev)
    pages = torch.from_numpy(normalize(rng.standard_normal((400, 32)).astype(np.float32)))
    pages = pages.reshape(40, 10, 32).to(dev)
    q = torch.from_numpy(normalize(rng.standard_normal((100, 32)).astype(np.float32))).to(dev)
    _, _, counts = ops.reuse_query_top1(q, lsh, slots, pages)
    cand = ref.probed_candidate_ids(slots, lsh.probe_batch(q)).cpu().numpy()
    assert counts.device.type == "cuda"
    assert np.array_equal(counts.cpu().numpy(), ops.unique_counts(cand))


# ------------------------------------- K3 split over candidates, K5 tiles
def _sorted_candidates(rng, B, N, C):
    """(B, C) sorted unique front-packed ids, -1 padded: row 0 full, with an
    exact tie between its first and last position (different splits); the
    last row all -1 (B > 1)."""
    ids = np.full((B, C), -1, np.int32)
    for r in range(B):
        k = C if r == 0 else int(rng.integers(C // 2, C + 1))
        ids[r, :k] = np.sort(rng.choice(N, k, replace=False))
    if B > 1:
        ids[-1] = -1
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("C", [511, 512, 513, 2047, 2048, 2049, 16384])
@pytest.mark.parametrize("D,paged", [(64, True), (64, False), (30, True)])
def test_gather_top1_matches_id_route(dev, B, C, D, paged):
    """On sorted unique candidates the first position is the lowest id, so
    gather_top1 and reuse_top1's id route give bit-equal (val, idx)."""
    rng = np.random.default_rng(B * C + D)
    N = 20000
    s = normalize(rng.standard_normal((N, D)).astype(np.float32))
    ids = _sorted_candidates(rng, B, N, C)
    s[ids[0, -1]] = s[ids[0, 0]]
    q = normalize(rng.standard_normal((B, D)).astype(np.float32))
    q[0] = s[ids[0, 0]]
    store = torch.from_numpy(s.reshape(200, 100, D) if paged else s).to(dev)
    args = [torch.from_numpy(q).to(dev), store, torch.from_numpy(ids).to(dev)]
    n0 = sim_topk.LAUNCHES["gather_top1"]
    gv, gi = sim_topk.gather_top1(*args)
    assert sim_topk.LAUNCHES["gather_top1"] == n0 + 1
    wv, wi = sim_topk.reuse_top1(*args)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    _same((gv, gi), ref.gather_top1_ref(*args))
    assert gi[0].item() == ids[0, 0]
    if B > 1:
        assert gi[-1].item() == -1 and torch.isneginf(gv[-1]).item()
    if C > 2048 or B == 1 and C > 512:
        assert sim_topk.gather_plan(B, C, D)["splits"] > 1


@pytest.mark.cuda
def test_gather_top1_no_candidate(dev):
    q, s = _unit(1, 64).to(dev), _unit(100, 64).to(dev)
    ids = torch.full((1, 5000), -1, dtype=torch.int32, device=dev)
    for fn in (sim_topk.gather_top1, sim_topk.reuse_top1):
        v, i = fn(q, s, ids)
        assert i.item() == -1 and torch.isneginf(v).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
def test_gather_top1_unaligned_views(dev, B):
    rng = np.random.default_rng(B)
    s = normalize(rng.standard_normal((5000, 64)).astype(np.float32))
    ids = _sorted_candidates(rng, B, 5000, 3000)
    q = normalize(rng.standard_normal((B, 64)).astype(np.float32))
    args = [torch.from_numpy(q).to(dev), torch.from_numpy(s.reshape(50, 100, 64)).to(dev),
            torch.from_numpy(ids).to(dev)]
    want = sim_topk.gather_top1(*args)
    for i in (0, 1):          # q, then the store, off a 16-byte boundary: 4-byte copies
        moved = list(args)
        moved[i] = _offset_view(args[i])
        for fn in (sim_topk.gather_top1, sim_topk.reuse_top1):
            got = fn(*moved)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 8, 130, 300])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("n_valid", [127, 128, 129, 2047, 2048, 2049])
def test_sim_top1_matches_id_route(dev, Q, D, n_valid):
    """sim_top1 over the first n_valid rows is reuse_top1 over the ids
    arange(n_valid) (-1 padded): bit-equal (val, idx), since both score a
    pair with one fmaf chain over D and break ties to the lowest index; a
    tie planted across the splits goes to the first index."""
    rng = np.random.default_rng(Q * D + n_valid)
    N = 2100
    s = normalize(rng.standard_normal((N, D)).astype(np.float32))
    s[n_valid - 1] = s[3]
    q = normalize(rng.standard_normal((Q, D)).astype(np.float32))
    q[0] = s[3]
    qd, sd = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    n0 = sim_topk.LAUNCHES["sim_top1"]
    gv, gi = sim_topk.sim_top1(qd, sd, n_valid)
    assert sim_topk.LAUNCHES["sim_top1"] == n0 + 1
    ids = torch.full((Q, N), -1, dtype=torch.int32)
    ids[:, :n_valid] = torch.arange(n_valid, dtype=torch.int32)
    wv, wi = sim_topk.reuse_top1(qd, sd, ids.to(dev))
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    assert gi[0].item() == 3 and (gi < n_valid).all()
    if n_valid > 2048:
        assert sim_topk.sim_plan(Q, n_valid, D)["splits"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("max_batch", [1, 8])
def test_async_engine_same_outcome_on_the_card(dev, max_batch):
    """A clustered trace with stragglers through ``AsyncServingEngine`` on the
    card (K4a per admission, K3 per flush) and on the CPU (the reference's
    numpy scoring): every request's reuse kind, replica, backup flag, result
    and virtual latency are equal, and so are the counters."""
    from repro_torch.serving import AsyncServingEngine, ReplicaEngine, ServeRequest
    from repro_torch.training.elastic import BackupPolicy

    rng = np.random.default_rng(11)
    base = normalize(rng.standard_normal((12, 32)).astype(np.float32))
    embs = normalize(base[rng.integers(0, 12, 200)]
                     + 0.04 * rng.standard_normal((200, 32)).astype(np.float32) / np.sqrt(32))
    arrivals = np.cumsum(rng.exponential(1 / 300.0, 200))

    def run(device):
        times = np.random.default_rng(5)
        execute = lambda batch: [round(float(np.sum(r.embedding)), 5) for r in batch]  # noqa: E731
        p = LSHParams(dim=32, num_tables=5, num_probes=8, seed=7)
        reps = [ReplicaEngine(i, p, execute, device=device) for i in range(3)]
        for r in reps:
            r.ttc.observe("svc", 0.05)
        eng = AsyncServingEngine(p, reps, backup=BackupPolicy(factor=1.5, max_backups=1),
                                 max_batch=max_batch, max_wait_s=0.01, device=device,
                                 exec_time_fn=lambda *a: 0.05 * (8.0 if times.random() < 0.1
                                                                 else 1.0))
        futs = [eng.submit_at(t, ServeRequest(i, "svc", embs[i], threshold=0.9))
                for i, t in enumerate(arrivals)]
        span = eng.drain()
        return span, eng.stats(), [(f.result.reuse, f.result.replica, f.result.backup,
                                    f.result.result, f.result.latency_s) for f in futs]

    card, cpu = run(dev), run("cpu")
    assert card == cpu
    assert card[1]["en"] > 0 and card[1]["backups"] > 0


def _golden_network(device, protocol, n_tasks=500):
    """tests/test_cosim.py's seeded trace (the testbed, ``stanford_ar``, 3
    users, a task every 12 ms, forwarding errors measured) on ``device``."""
    from repro_torch.core.network import ReservoirNetwork
    from repro_torch.core.topology import testbed_topology
    from repro_torch.data import DATASETS, dataset_service, make_stream

    g, ens = testbed_topology()
    net = ReservoirNetwork(g, ens, LSHParams(dim=64, num_tables=5, num_probes=8), seed=0,
                           protocol=protocol, measure_fwd_errors=True, device=device)
    spec = DATASETS["stanford_ar"]
    net.register_service(dataset_service(spec))
    for u in range(3):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(spec, n_tasks, seed=7)
    for i, x in enumerate(X):
        net.submit_task(f"u{i % 3}", spec.name, x, 0.9, at_time=0.012 * i)
    net.run()
    return net


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["direct", "ttc"])
def test_golden_trace_on_the_card(dev, protocol):
    """The 500-task trace with the client hash and the EN stores on the card
    (K4a, K3 for every query and forwarding-error peek): every record's
    outcome equals the CPU run's (which tests/test_torch_network.py holds to
    the reference and its pinned summary), similarities within 1e-6."""
    card, cpu = _golden_network(dev, protocol), _golden_network("cpu", protocol)
    assert all(s.device.type == "cuda" for en in card.edge_nodes.values()
               for s in en.stores.values())
    for a, b in zip(card.metrics.records, cpu.metrics.records):
        assert (a.t_complete, a.reuse, a.correct, a.forwarding_error, a.reuse_node) == (
            b.t_complete, b.reuse, b.correct, b.forwarding_error, b.reuse_node)
        assert abs(a.similarity - b.similarity) <= 1e-6
    assert card.metrics.summary() == cpu.metrics.summary()


@pytest.mark.cuda
def test_engine_backend_on_the_card(dev):
    """``EngineBackend`` behind the network with every store on the card (EN
    stores, replica stores, the routers' hash): records and counters equal a
    CPU run's (virtual execution times)."""
    from repro_torch.core.edge_node import Service
    from repro_torch.core.network import ReservoirNetwork
    from repro_torch.core.topology import line_topology
    from repro_torch.serving import EngineBackend
    from repro_torch.training.elastic import BackupPolicy

    rng = np.random.default_rng(11)
    base = normalize(rng.standard_normal((6, 16)).astype(np.float32))
    X = normalize(base[rng.integers(0, 6, 150)]
                  + 0.03 * rng.standard_normal((150, 16)).astype(np.float32))

    def run(device):
        g, ens = line_topology(2, link_delay_s=1e-3)
        be = EngineBackend(n_replicas=2, max_batch=8, max_wait_s=0.004, seed=3,
                           backup=BackupPolicy(factor=1.5, max_backups=1))
        net = ReservoirNetwork(g, ens, LSHParams(dim=16, num_tables=5, num_probes=8),
                               seed=0, user_link_delay_s=1e-3, en_batch_window_s=0.008,
                               backend=be, device=device)
        net.register_service(Service("/svc", execute=lambda x: round(float(np.sum(x)), 5),
                                     input_dim=16))
        net.add_user("u1", 0)
        net.add_user("u2", 0)
        for i, x in enumerate(X):
            net.submit_task("u1" if i % 2 else "u2", "svc", x, 0.9, at_time=0.004 * i)
        net.run()
        return net, be

    (card, cbe), (cpu, pbe) = run(dev), run("cpu")
    for engine in cbe.engines.values():
        assert all(r.device.type == "cuda" for r in engine.replicas)
    assert cbe.stats() == pbe.stats() and cbe.stats()["executed"] > 0
    for a, b in zip(card.metrics.records, cpu.metrics.records):
        assert (a.t_complete, a.reuse, a.result, a.aggregated) == (
            b.t_complete, b.reuse, b.result, b.aggregated)
        assert abs(a.similarity - b.similarity) <= 1e-6


# ------------------------------------------------------- K6's backward
_BWD_CASES = [(2, 200, 200, 8, 4, 128, {}), (1, 130, 130, 4, 2, 256, {"softcap": 30.0}),
              (2, 96, 96, 8, 4, 32, {"window": 17}),
              (1, 70, 150, 4, 2, 128, {"causal": False, "softcap": 5.0}),
              (1, 48, 16, 4, 4, 16, {"window": 8}),          # rows that see no key
              (1, 100, 100, 8, 1, 64, {"scale": 0.3, "window": 40}),
              (2, 80, 80, 8, 8, 96, {}), (1, 90, 90, 4, 2, 112, {}),
              (1, 77, 77, 4, 4, 128, {}),                    # G = 1
              (1, 203, 203, 6, 2, 64, {}),                   # G = 3: 21-position tiles, ragged S
              (2, 333, 333, 16, 2, 128, {"window": 100}),    # G = 8, ragged S
              # the other families' training shapes: zamba2 (D=112, G=1),
              # phi-3-vision (D=96, G=1), seamless's encoder and cross attention
              (1, 300, 300, 4, 4, 112, {}), (1, 257, 257, 4, 4, 96, {}),
              (2, 256, 256, 4, 4, 64, {"causal": False}),
              (1, 190, 330, 4, 4, 64, {"causal": False})]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D,kw", _BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward(dev, B, S, T, H, KV, D, kw, dtype):
    """Through autograd: the forward with lse, then the three backward
    kernels (one launch each), against the plain backward on the same
    forward output and lse; f32 within 2e-5 of each gradient's largest
    value, bf16 within that plus one bf16 ulp."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev).requires_grad_() for x in _qkv(B, S, T, H, KV, D, dtype))
    dout = torch.from_numpy(RNG.standard_normal((B, S, H, D)).astype(np.float32)).to(dev, dtype)
    n0 = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert {n: fa.LAUNCHES[n] - n0[n] for n in n0} == {
        "flash_attention": 1, "flash_attention_bwd_delta": 1, "flash_attention_bwd_dkdv": 1,
        "flash_attention_bwd_dq": 1}
    masks = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
             kw.get("scale", D ** -0.5))
    with torch.no_grad():
        o2, lse = fa.forward(q, k, v, *masks, with_lse=True)
        want_out, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o2, lse, dout, **kw)
    assert torch.equal(out, o2)                      # the same forward, with or without lse
    inf = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), inf)
    _close(lse[~inf], want_lse[~inf], 1e-5 * max(1.0, want_lse[~inf].abs().max().item()))
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        lim = 2e-5 * w.float().abs().max().item()
        err = (g.float() - w.float()).abs()
        if dtype == torch.bfloat16:
            err = err - w.float().abs() * 2.0 ** -7
        assert err.max().item() <= lim


# (B, S, T, H, KV, D, q_offset, kw): chunks of a longer prompt (T = q_offset +
# S), a ragged T on either side of it, windows that start inside the chunk
_QOFF_CASES = [(2, 128, 640, 8, 4, 128, 512, {}), (1, 100, 300, 8, 2, 64, 200, {"window": 90}),
               (1, 70, 200, 4, 4, 96, 130, {"softcap": 20.0}),
               (2, 96, 150, 16, 8, 128, 64, {}),              # T < q_offset + S: late keys cut
               (1, 64, 200, 4, 2, 256, 100, {}),              # keys past the last row's position
               (1, 90, 700, 4, 1, 112, 610, {"window": 33, "softcap": 30.0}),
               (1, 33, 50, 4, 2, 32, 17, {"causal": False})]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D,q_offset,kw", _QOFF_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_q_offset(dev, B, S, T, H, KV, D, q_offset, kw, dtype):
    """K6 with ``q_offset`` forward and backward (through autograd) against
    the plain versions at the same offset: f32 within 2e-5 of the largest
    value, bf16 within that plus one bf16 ulp (the tolerances of the tests
    above)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev).requires_grad_() for x in _qkv(B, S, T, H, KV, D, dtype))
    dout = torch.from_numpy(RNG.standard_normal((B, S, H, D)).astype(np.float32)).to(dev, dtype)
    out = fa.flash_attention(q, k, v, q_offset=q_offset, **kw)
    got = torch.autograd.grad(out, (q, k, v), dout)
    masks = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
             kw.get("scale", D ** -0.5))
    with torch.no_grad():
        o2, lse = fa.forward(q, k, v, *masks, with_lse=True, q_offset=q_offset)
        want_out, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                     q_offset=q_offset, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o2, lse, dout, q_offset=q_offset, **kw)
    assert torch.equal(out, o2)
    inf = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), inf)
    _close(lse[~inf], want_lse[~inf], 1e-5 * max(1.0, want_lse[~inf].abs().max().item()))
    for g, w in [(out, want_out), *zip(got, want)]:
        assert g.dtype == dtype and torch.isfinite(g).all()
        lim = 2e-5 * w.float().abs().max().item()
        err = (g.float() - w.float()).abs()
        if dtype == torch.bfloat16:
            err = err - w.float().abs() * 2.0 ** -7
        assert err.max().item() <= lim


@pytest.mark.cuda
def test_flash_attention_chunks_equal_one_call(dev):
    """A 512-row prompt's four 128-row chunks at q_offset 0, 128, 256, 384
    (each against the keys so far) give the one-call rows bit for bit: a
    row's visible keys and their tiles are the same either way."""
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dev) for x in _qkv(2, 512, 512, 16, 8, 128, dtype))
        whole = fa.flash_attention(q, k, v)
        parts = [fa.flash_attention(q[:, lo:lo + 128], k[:, :lo + 128], v[:, :lo + 128],
                                    q_offset=lo) for lo in range(0, 512, 128)]
        assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.cuda
def test_flash_attention_backward_takes_the_wgmma_route(dev, monkeypatch):
    """A bf16 call at D=128 launches dK/dV and dQ with the route and launch
    shape of ``bwd_launch_plan`` (the tensor cores); f32 with the CUDA-core
    route's zeros."""
    from repro_torch.kernels import flash_attention as fa

    calls = []
    launch = fa.build.launch

    def recording(name, fn, device, *args):
        calls.append((fn, args))
        return launch(name, fn, device, *args)

    monkeypatch.setattr(fa.build, "launch", recording)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dev) for x in _qkv(2, 100, 100, 8, 4, 128, dtype))
        out, lse = fa.forward(q, k, v, True, None, None, 0.1, with_lse=True)
        calls.clear()
        fa.backward(q, k, v, out, lse, torch.randn_like(q), True, None, None, 0.1)
        plan = fa.bwd_launch_plan(dtype, 2, 100, 100, 8, 4, 128)
        assert plan["route"] == ("wgmma" if dtype == torch.bfloat16 else "fma")
        for kernel in ("dkdv", "dq"):
            args = dict(calls)[f"flash_attention_bwd_{kernel}_launch"]
            assert args[-10:] == fa.bwd_launch_args(plan, kernel)
            assert args[-10] == (1 if dtype == torch.bfloat16 else 0)


@pytest.mark.cuda
def test_flash_attention_backward_is_deterministic(dev):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.to(dev) for x in _qkv(2, 300, 300, 16, 8, 128, torch.bfloat16))
    dout = torch.randn_like(q)
    out, lse = fa.forward(q, k, v, True, None, None, 0.1, with_lse=True)
    a = fa.backward(q, k, v, out, lse, dout, True, None, None, 0.1)
    b = fa.backward(q, k, v, out, lse, dout, True, None, None, 0.1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# reduced config -> (K6 forward launches of one loss and backward, with the
# remat recompute; launches of each backward entry point): one attention a
# decoder layer, one a shared-block application (zamba2: one group), one an
# encoder layer and two a decoder layer (seamless), none in xLSTM
_TRAIN_LAUNCHES = {"qwen3-1.7b": (4, 2), "zamba2-7b": (2, 1), "xlstm-125m": (0, 0),
                   "seamless-m4t-large-v2": (12, 6), "qwen2-moe-a2.7b": (4, 2),
                   "llama4-maverick-400b-a17b": (4, 2), "phi-3-vision-4.2b": (4, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _TRAIN_LAUNCHES)
def test_decoder_loss_gives_every_parameter_a_gradient(dev, arch):
    """Each family's reduced config in its training construction: every
    parameter gets a non-zero gradient on the card (attention's through K6's
    backward; the forward again in the remat recompute), within 1e-4 of the
    CPU's.  An MoE model routes alike on both (the reduced capacity drops
    no token)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_arch(arch).reduced()
    cpu = build_model(cfg, "cpu", seed=1, trainable=True)
    card = build_model(cfg, dev, seed=1, trainable=True)
    with torch.no_grad():
        for p, c in zip(card.parameters(), cpu.parameters()):
            p.copy_(c)
    batch = {"tokens": torch.from_numpy(RNG.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)),
             "labels": torch.from_numpy(RNG.integers(-1, cfg.vocab_size, (4, 40)).astype(np.int32))}
    extra = {"patch_embeds": cfg.n_frontend_tokens if cfg.frontend == "vision" else 0,
             "frames": 20 if cfg.is_encdec else 0}
    for name, n in extra.items():
        if n:
            batch[name] = torch.from_numpy(
                (RNG.standard_normal((4, n, cfg.d_model)) * 0.02).astype(np.float32))
    ops.reset_launch_counts()
    card.loss({k: v.to(dev) for k, v in batch.items()})[0].backward()
    counts = ops.launch_counts()
    fwd, bwd = _TRAIN_LAUNCHES[arch]
    assert counts["flash_attention"] == fwd
    assert all(counts[f"flash_attention_bwd_{e}"] == bwd for e in ("delta", "dkdv", "dq"))
    cpu.loss(batch)[0].backward()
    for (name, p), c in zip(card.named_parameters(), cpu.parameters()):
        assert p.grad is not None and bool(p.grad.any()), name
        err = (p.grad.cpu() - c.grad).abs().max() / c.grad.abs().max()
        assert err.item() <= 1e-4, name
