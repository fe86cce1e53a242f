"""K6's backward launch plan and the rounding of its bf16 route, on the CPU.

The backward kernels (``csrc/flash_attention_bwd.cu``) run only on a card;
what surrounds them is Python: ``bwd_launch_plan`` picks the route from the
dtype (bf16 on the tensor cores at every width, D=256 in two column halves;
f32 on the CUDA cores) and computes the tensor-core route's launch shape,
TMA boxes and swizzle, which the kernels check against what they were
compiled for.  These tests hold the plan to what the kernels assume, and
record why the bf16 route splits P and dS into a bf16 hi + lo pair: a
plain-torch emulation of that rounding stays within the limit the card's
checks hold the backward to, and the same emulation with one bf16 rounding
(what SDPA's and FlashAttention-3's backwards do) does not.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# the card's limit (chip_smoke.py BWD_REL_TOL, tests/test_torch_cuda.py):
# 2e-5 of each gradient's largest value plus one bf16 ulp of each value
REL_TOL = 2e-5
# ptxas gives a thread of a 384-thread block at most 168 registers
# (65536 / 384, in steps of 8); setmaxnreg moves registers only at run time
REGS_384 = 168


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_route_follows_dtype_and_width(D):
    tc = fa.bwd_launch_plan(torch.bfloat16, 2, 100, 100, 16, 8, D)
    assert tc["route"] == "wgmma"
    f32 = fa.bwd_launch_plan(torch.float32, 2, 100, 100, 16, 8, D)
    assert f32["route"] == "fma"
    assert fa.bwd_launch_args(f32, "dkdv") == fa.bwd_launch_args(f32, "dq") == (0,) * 10
    for kernel in ("dkdv", "dq"):
        args = fa.bwd_launch_args(tc, kernel)
        assert len(args) == 10 and args[0] == 1


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        fa.bwd_launch_plan(torch.bfloat16, 1, 8, 8, 4, 4, 48)      # no compiled width
    with pytest.raises(TypeError):
        fa.bwd_launch_plan(torch.float16, 1, 8, 8, 4, 4, 64)
    with pytest.raises(ValueError):
        fa.bwd_launch_plan(torch.bfloat16, 1, 8, 8, 128, 1, 64)    # G = 128 > 64 rows
    assert fa.bwd_launch_plan(torch.float32, 1, 8, 8, 128, 1, 64)["route"] == "fma"
    assert fa.bwd_launch_plan(torch.bfloat16, 1, 8, 8, 8, 1, 256)["route"] == "wgmma"
    with pytest.raises(ValueError):
        fa.bwd_launch_plan(torch.bfloat16, 1, 8, 8, 128, 1, 256)   # G = 128 at D = 256 too


# ------------------------------------------------------------------ shapes
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 64])
def test_boxes_rows_and_budgets(D, G):
    """A chunk of D whose row bytes are the swizzle width; tiles of whole
    chunks holding D (96 and 112: 128 columns); a q box over the G heads of
    one kv head and whole positions of at most one tile's rows; boxes within
    TMA's 256 a side; each kernel's shared memory within the H100's; a
    consumer thread's one accumulator (at most 128 columns: D=256 in two
    column halves) and one tile of S, dP and the split words within
    ptxas's registers."""
    p = fa.bwd_launch_plan(torch.bfloat16, 1, 50, 50, 2 * G, 2, D)
    chunk, width, tile = p["chunk"], p["tile_width"], p["tile"]
    (qc, qh, qp, qb), (kc, kh, kt, kb) = p["q_box"], p["kv_box"]
    assert width % chunk == 0 and D <= width < D + chunk and width % 16 == 0
    assert width == (128 if D in (96, 112) else D)
    assert chunk * 2 == p["swizzle_bytes"] in (32, 64, 128)
    assert qc == kc == chunk and qb == kb == kh == 1 and kt == tile
    assert qh == G and qp * G <= tile < (qp + 1) * G       # at most G - 1 rows idle
    assert all(1 <= b <= 256 for b in p["q_box"] + p["kv_box"])
    assert p["threads"] == 128 * (p["warpgroups"] + 1) == 384 and p["stages"] >= 2
    tile_bytes = tile * width * 2
    bars = 8 * (1 + 2 * p["stages"])
    dkdv = 1024 + (2 + 2 * p["stages"]) * tile_bytes + (2 * p["stages"] + 1) * tile * 4 + bars
    dq = 1024 + (2 * p["q_tiles"] + 2 * p["stages"]) * tile_bytes + bars
    assert max(dkdv, dq) <= build.SMEM_LIMIT
    acc, halves = p["acc_cols"], p["col_halves"]
    assert acc * halves == width and acc <= 128 and acc % chunk == 0
    assert (halves, p["q_tiles"]) == ((2, 1) if D == 256 else (1, p["warpgroups"]))
    assert acc // 2 + 3 * tile // 2 <= REGS_384


@pytest.mark.parametrize("S,T,G", [(1, 1, 1), (63, 63, 2), (64, 64, 2), (65, 65, 2),
                                   (333, 333, 8), (1000, 700, 5), (2048, 2048, 2),
                                   (203, 203, 3), (4096, 4096, 1), (70, 150, 64)])
def test_grid_covers_every_key_and_row_tile_once(S, T, G):
    """dK/dV block x takes keys [x * tile, (x + 1) * tile); dQ block x takes
    positions [x * step, (x + 1) * step), step = warpgroups * q_box
    positions: together they hold T and S, each key and position once, and
    no block is empty."""
    p = fa.bwd_launch_plan(torch.bfloat16, 2, S, T, 2 * G, 2, 128)
    assert p["dkdv_grid"][1:] == p["dq_grid"][1:] == (2, 2)
    for n, step, grid in ((T, p["tile"], p["dkdv_grid"]),
                          (S, p["warpgroups"] * p["q_box"][2], p["dq_grid"])):
        seen = np.zeros(n, int)
        for x in range(grid[0]):
            assert x * step < n
            seen[x * step:(x + 1) * step] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("S,T,G", [(1, 1, 1), (63, 63, 2), (65, 65, 2), (333, 333, 8),
                                   (1000, 700, 5), (2048, 2048, 1), (70, 150, 64)])
def test_grid_covers_every_key_half_and_row_tile_once_at_d256(S, T, G):
    """At D=256 dK/dV block x takes keys [x // 2 * tile, (x // 2 + 1) * tile)
    and column half x % 2; a dQ block takes positions [x * step, (x + 1) *
    step), step = one q box (both warpgroups share its rows): each (key,
    half) and each position once, no block empty."""
    p = fa.bwd_launch_plan(torch.bfloat16, 2, S, T, 2 * G, 2, 256)
    assert p["col_halves"] == 2 and p["q_tiles"] == 1 and p["acc_cols"] == 128
    seen = np.zeros((T, 2), int)
    for x in range(p["dkdv_grid"][0]):
        t0 = x // 2 * p["tile"]
        assert t0 < T
        seen[t0:t0 + p["tile"], x % 2] += 1
    assert (seen == 1).all()
    step, seen = p["q_box"][2], np.zeros(S, int)
    for x in range(p["dq_grid"][0]):
        assert x * step < S
        seen[x * step:(x + 1) * step] += 1
    assert (seen == 1).all()


def test_grid_at_gemma_training():
    """gemma-2b (H=8, KV=1: MQA) and gemma2-9b (H=16, KV=8) at B=4, S=2048:
    the column halves double the dK/dV grid (gemma-2b: 256 blocks for the
    H100's 132 SMs, 128 without them)."""
    p = fa.bwd_launch_plan(torch.bfloat16, 4, 2048, 2048, 8, 1, 256)
    assert p["dkdv_grid"] == (64, 1, 4) and p["dq_grid"] == (256, 1, 4)
    assert fa.bwd_launch_args(p, "dkdv") == (1, 2, 384, 2, 64, 64, 128, 8, 8, 64)
    assert fa.bwd_launch_args(p, "dq") == (1, 2, 384, 2, 64, 64, 128, 8, 8, 256)
    p = fa.bwd_launch_plan(torch.bfloat16, 4, 2048, 2048, 16, 8, 256)
    assert p["dkdv_grid"] == (64, 8, 4) and p["dq_grid"] == (64, 8, 4)


def test_grid_fills_the_card_at_qwen3_training():
    p = fa.bwd_launch_plan(torch.bfloat16, 4, 2048, 2048, 16, 8, 128)
    assert p["dkdv_grid"] == (32, 8, 4) and p["dq_grid"] == (32, 8, 4)
    assert fa.bwd_launch_args(p, "dkdv") == (1, 2, 384, 2, 64, 64, 128, 2, 32, 32)


# ------------------------------------------------------------------ rounding
def _emulated_bwd(q, k, v, out, lse, dout, scale, rounding):
    """The bf16 route's arithmetic in plain torch (causal): S and dP in fp32
    from the bf16 inputs, P and dS in fp32, then rounded before the dV, dK
    and dQ products as ``rounding`` says ("split": bf16 hi + bf16 lo of the
    rest, the kernels' two wgmmas; "bf16": one bf16), the products summed
    in fp32 and the outputs rounded to bf16."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg, do = (x.reshape(B, S, KV, G, D).float() for x in (q, dout))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf)
    mask = torch.ones(S, T, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, KV, G, S, 1)), 0.0)
    delta = (do * out.reshape(B, S, KV, G, D).float()).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", do, vf) - delta[..., None])

    def rounded(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if rounding == "split" else hi

    p, ds = rounded(p), rounded(ds)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    return tuple(x.bfloat16() for x in (dq.reshape(B, S, H, D), dk, dv))


def _values_over_the_limit(got, want) -> int:
    g, w = got.float(), want.float()
    lim = REL_TOL * w.abs().max() + w.abs() * 2.0 ** -7
    return int(((g - w).abs() > lim).sum())


def test_split_rounding_meets_the_limit_and_one_bf16_does_not():
    """At a causal GQA shape (B=1, S=512, H=4, KV=2, D=128, bf16 inputs) the
    hi/lo split of P and dS keeps every gradient value within 2e-5 of its
    tensor's largest value plus one bf16 ulp of the plain backward
    (``ref.flash_attention_bwd_ref``, fp32); rounding P and dS to one bf16
    each puts values of every gradient outside it."""
    rng = np.random.default_rng(21)
    B, S, H, KV, D = 1, 512, 4, 2, 128
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                     for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    scale = D ** -0.5
    with torch.no_grad():
        out, lse = ref.flash_attention_ref(q, k, v, scale=scale, return_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, scale=scale)
        split = _emulated_bwd(q, k, v, out, lse, dout, scale, "split")
        single = _emulated_bwd(q, k, v, out, lse, dout, scale, "bf16")
    assert [_values_over_the_limit(g, w) for g, w in zip(split, want)] == [0, 0, 0]
    assert all(_values_over_the_limit(g, w) > 0 for g, w in zip(single, want))


def _fp64_bwd(q, k, v, out, dout, scale):
    """(dq, dk, dv) of causal GQA attention in float64 from the inputs the
    kernels take (``out``: the forward's bf16 output, which delta reads),
    as ``ref.flash_attention_bwd_ref`` writes it out, with P from float64
    logits and their float64 log-sum-exp."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg, do, og = (x.reshape(B, S, KV, H // KV, D).double() for x in (q, dout, out))
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k64) * scale
    mask = torch.ones(S, T, dtype=torch.bool).tril()
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = (do * og).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", do, v64) - delta[..., None])
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k64) * scale
    return dq.reshape(B, S, H, D), dk, dv


def test_split_rounding_meets_the_limit_at_head_width_256():
    """The same at gemma-2b's head width and MQA (B=1, S=256, H=8, KV=1,
    D=256, causal, bf16 inputs) against the gradient in float64 from the
    same inputs (``_fp64_bwd``; the bf16 rounding of the forward's out is
    every bf16 backward's, not the split's): the hi/lo split keeps every
    value of dq, dk and dv within the limit; one bf16 rounding of P and dS
    does not."""
    rng = np.random.default_rng(31)
    B, S, H, KV, D = 1, 256, 8, 1, 256
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                     for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    scale = D ** -0.5
    with torch.no_grad():
        out, lse = ref.flash_attention_ref(q, k, v, scale=scale, return_lse=True)
        want = _fp64_bwd(q, k, v, out, dout, scale)
        split = _emulated_bwd(q, k, v, out, lse, dout, scale, "split")
        single = _emulated_bwd(q, k, v, out, lse, dout, scale, "bf16")
    assert [_values_over_the_limit(g, w) for g, w in zip(split, want)] == [0, 0, 0]
    assert all(_values_over_the_limit(g, w) > 0 for g, w in zip(single, want))
