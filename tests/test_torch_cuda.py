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
    """On a CUDA store, staged batches and scalar queries below
    use_kernel_threshold still launch gather_top1, and agree with a CPU
    store fed the same inserts."""
    from repro_torch.core.reuse_store import ReuseStore

    p = LSHParams(dim=32, num_tables=3, num_probes=4, seed=5)
    x = normalize(RNG.standard_normal((300, 32)).astype(np.float32))
    q = normalize(x[:4] + 0.01 * RNG.standard_normal((4, 32)).astype(np.float32))
    stores = [ReuseStore(p, capacity=512, device=d) for d in (dev, "cpu")]
    for s in stores:
        s.insert_batch(x, list(range(300)))
    n0 = sim_topk.LAUNCHES["gather_top1"]
    gpu, cpu = (s.query_batch(q, 0.5, peek=True) for s in stores)
    one = stores[0].query(q[0], 0.5)
    assert sim_topk.LAUNCHES["gather_top1"] == n0 + 2
    assert [r[2] for r in gpu] == [r[2] for r in cpu] and one[2] == gpu[0][2]
    assert max(abs(a[1] - b[1]) for a, b in zip(gpu, cpu)) <= TOL
