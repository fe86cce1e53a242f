"""Launch plans of the attention kernels, on the CPU.

The CUDA kernels run only on a card, but what surrounds them is Python:
K6's route by dtype and head width, the launch shape, TMA boxes, swizzle
and strides handed to its bf16 kernel, and K7's split of the slot axis.
These tests hold those plans to what the kernels assume: every position
and every valid slot is covered once, no split is spent past kv_len, the
grid fills the H100's 132 SMs at qwen3-1.7b's shapes, and strides that TMA
cannot take are refused.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

SMS = 132   # H100 SXM


# ------------------------------------------------------------------ K6 route
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_route_follows_the_dtype(D):
    tc = fa.launch_plan(torch.bfloat16, 2, 100, 100, 16, 8, D)
    assert tc["route"] == "wgmma" and len(fa.tc_launch_args(tc)) == 9
    f32 = fa.launch_plan(torch.float32, 2, 100, 100, 16, 8, D)
    assert f32["route"] == "fma" and fa.tc_launch_args(f32) == (0,) * 9


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        fa.launch_plan(torch.bfloat16, 1, 8, 8, 4, 4, 48)      # no compiled width
    with pytest.raises(TypeError):
        fa.launch_plan(torch.float16, 1, 8, 8, 4, 4, 64)
    with pytest.raises(ValueError):
        fa.launch_plan(torch.bfloat16, 1, 8, 8, 128, 1, 64)    # G = 128 > 64 rows
    assert fa.launch_plan(torch.float32, 1, 8, 8, 128, 1, 64)["route"] == "fma"


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 64])
def test_tc_boxes_and_rows(D, G):
    """What the kernel and TMA take of the plan: a chunk of D whose row bytes
    are the swizzle width, tiles of whole chunks that hold D (D=96 and 112:
    128 columns, the last chunk past D), a q box over the G heads of one kv
    head and whole positions of at most 64 rows, boxes within TMA's 256 a
    side."""
    p = fa.launch_plan(torch.bfloat16, 1, 50, 50, 2 * G, 2, D)
    chunk, (qc, qh, qp, qb), (kc, kh, kt, kb) = p["chunk"], p["q_box"], p["kv_box"]
    width = p["tile_width"]
    assert width % chunk == 0 and D <= width < D + chunk and width % 16 == 0
    assert width == (128 if D in (96, 112) else D)
    assert chunk * 2 == p["swizzle_bytes"] in (32, 64, 128)
    assert qc == kc == chunk and qb == kb == kh == 1 and kt == p["key_tile"]
    assert qh == G and qp * G <= fa.TC_ROWS < (qp + 1) * G     # at most G - 1 rows idle
    assert all(1 <= b <= 256 for b in p["q_box"] + p["kv_box"])
    assert p["key_tile"] % 16 == 0 and p["threads"] == 128 * (p["warpgroups"] + 1)
    assert p["stages"] >= 2
    # a consumer thread holds width/2 fp32 of acc, key_tile/2 of S and
    # key_tile/2 words of P (hi and lo): with addresses and masks, within its
    # 232 registers
    assert width // 2 + p["key_tile"] <= 200
    assert fa.tc_launch_args(p) == (p["warpgroups"], p["threads"], p["stages"], p["key_tile"],
                                    chunk, p["swizzle_bytes"], qh, qp, p["grid"][0])


@pytest.mark.parametrize("S,G", [(1, 1), (63, 2), (64, 2), (65, 2), (333, 8), (1000, 5),
                                 (2048, 2), (4096, 1)])
def test_tc_blocks_cover_every_position_once(S, G):
    """Block x of the grid takes positions [x * step, (x + 1) * step), step =
    warpgroups * q_box positions: together they hold S, and none is empty."""
    p = fa.launch_plan(torch.bfloat16, 1, S, S, G, 1, 128)
    step = p["warpgroups"] * p["q_box"][2]
    seen = np.zeros(S, int)
    for x in range(p["grid"][0]):
        assert x * step < S                            # no block without a row
        seen[x * step:(x + 1) * step] += 1
    assert (seen == 1).all()


def test_tc_grid_fills_the_card_at_qwen3_prefill():
    p = fa.launch_plan(torch.bfloat16, 4, 2048, 2048, 16, 8, 128)
    assert p["grid"] == (32, 8, 4) and np.prod(p["grid"]) >= SMS


@pytest.mark.parametrize("D", [96, 112])
def test_padded_widths_feed_tma(D):
    """At D = 96 and 112 the rows of q, k, v are 192 and 224 bytes: every
    stride a multiple of 16 bytes, as TMA needs, in place (no padded copy);
    the q box of two 64-column chunks covers the tile, TMA's zero fill the
    columns past D; zamba2's and phi-3-vision's prefills (G = 1) take 64
    positions a warpgroup."""
    for S, H in ((1535, 32), (2111, 32)):
        q = torch.zeros(2, S, H, D, dtype=torch.bfloat16)
        assert fa.tma_strides(q) == (S * H * D, H * D, D)
        assert all(s * 2 % 16 == 0 for s in fa.tma_strides(q))
        p = fa.launch_plan(torch.bfloat16, 2, S, S, H, H, D)
        assert p["q_box"] == (64, 1, 64, 1) and p["kv_box"] == (64, 1, 64, 1)
        assert p["tile_width"] // p["chunk"] == 2 and p["grid"] == (-(-S // 128), H, 2)


def test_tma_strides():
    x = torch.zeros(2, 10, 4, 64, dtype=torch.bfloat16)
    assert fa.tma_strides(x) == (10 * 4 * 64, 4 * 64, 64)
    # a kv head sliced out of (B, T, 2 * KV, D): strides stay as they are
    assert fa.tma_strides(torch.zeros(2, 10, 8, 64, dtype=torch.bfloat16)[:, :, :4]) == \
        (10 * 8 * 64, 8 * 64, 64)
    # an axis of length 1 is never stepped: its stride is replaced
    one = torch.zeros(1, 10, 4, 64, dtype=torch.bfloat16).transpose(0, 0)
    assert fa.tma_strides(one.as_strided(one.shape, (3, 256, 64, 1)))[0] == 10 * 4 * 64
    with pytest.raises(ValueError):        # 40 bytes between heads
        fa.tma_strides(torch.zeros(2, 10, 4, 24, dtype=torch.bfloat16)[..., :16]
                       .as_strided((2, 10, 4, 16), (960, 96, 20, 1)))
    with pytest.raises(ValueError):        # a broadcast (stride 0) axis
        fa.tma_strides(torch.zeros(1, 10, 1, 64, dtype=torch.bfloat16).expand(2, 10, 4, 64))


# ------------------------------------------------------------------ K7 split
@pytest.mark.parametrize("B,KV,T,G,D", [(4, 8, 2064, 2, 128), (1, 1, 64, 8, 256),
                                        (2, 2, 96, 4, 64), (8, 32, 300, 1, 96),
                                        (2, 8, 5000, 5, 128), (1, 4, 7, 2, 32)])
def test_split_plan_covers_every_valid_slot_once(B, KV, T, G, D):
    p = da.split_plan(B, KV, T, G, D, 2)
    n = p["n_split"]
    for length in sorted({0, 1, 2, 15, 16, 17, T - 1, T, *range(0, T + 1, max(1, T // 7))}):
        length = min(max(length, 0), T)
        c = da.row_chunk(length, n)
        assert c % da.CHUNK_ALIGN == 0
        seen = np.zeros(T + c * n, int)
        for s in range(n):
            lo, hi = s * c, min((s + 1) * c, length)
            if lo < hi:
                seen[lo:hi] += 1
        assert (seen[:length] == 1).all() and not seen[length:].any()
        # no block is spent past the row's valid slots
        assert -(-length // c) <= n


def test_split_plan_boundaries_of_the_chunk():
    p = da.split_plan(4, 8, 2064, 2, 128, 2)
    n = p["n_split"]
    c = da.row_chunk(2064, n)
    for length in (c - 1, c, c + 1, 2 * c + 1):
        cl = da.row_chunk(length, n)
        assert cl * n >= length and (cl - da.CHUNK_ALIGN) * n < max(length, 1)


def test_split_plan_fills_the_card_at_qwen3_decode():
    p = da.split_plan(4, 8, 2064, 2, 128, 2)
    assert np.prod(p["grid"]) >= SMS and p["grid"] == (p["n_split"], 8, 4)
    # the ring-cache row with 2064 valid slots uses every split
    assert -(-2064 // da.row_chunk(2064, p["n_split"])) == p["n_split"]


@pytest.mark.parametrize("D,cache_bytes", list(itertools.product((16, 32, 64, 96, 128, 256),
                                                                 (2, 4))))
def test_split_plan_lanes_cover_a_row(D, cache_bytes):
    p = da.split_plan(2, 2, 100, 2, D, cache_bytes)
    lanes, ppl = p["lanes"], p["pieces_per_lane"]
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32 and ppl in (1, 2)
    assert lanes * ppl * 16 >= D * cache_bytes > (lanes * ppl * 16) // 2 - 16
    assert p["lanes_log2"] == lanes.bit_length() - 1


@pytest.mark.parametrize("G", range(1, 17))
def test_heads_per_block(G):
    hpb = da.heads_per_block(G)
    assert hpb in (1, 2, 4, 8) and (hpb >= G or hpb == 8)
    p = da.split_plan(1, 2, 64, G, 64, 2)
    assert p["head_groups"] * hpb >= G > (p["head_groups"] - 1) * hpb
