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

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

SMS = 132   # H100 SXM


def tc_smem_bytes(plan: dict) -> int:
    """Dynamic shared memory of K6's bf16 route (``tc::Cfg::kSmem``): 1 KB of
    alignment, each warpgroup's Q tile, the K and V rings, the mbarriers."""
    width, stages = plan["tile_width"], plan["stages"]
    return (1024 + plan["warpgroups"] * fa.TC_ROWS * width * 2
            + 2 * stages * plan["key_tile"] * width * 2 + 8 * (1 + 4 * stages))


def tc_block(plan: dict, S: int, KV: int, x: int):
    """(position tile, kv head, batch) of block x of a wide (D=256) grid,
    as ``flash_tc_kernel`` reads it: tiles in reverse (the longest causal
    range first), every (kv head, batch) of a tile before the next tile."""
    tiles = -(-S // (plan["warpgroups"] * plan["q_box"][2]))
    per = plan["grid"][0] // tiles          # KV * B
    return tiles - 1 - x // per, x % per % KV, x % per // KV


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
    # consumer warpgroups and a producer warpgroup; at the wide widths the
    # consumers load (256 threads of up to 255 registers)
    producer = 0 if D in fa.TC_WIDE else 128
    assert p["key_tile"] % 16 == 0 and p["threads"] == 128 * p["warpgroups"] + producer
    assert p["stages"] >= 2
    # a consumer thread holds width/2 fp32 of acc, key_tile/2 of S and
    # key_tile/2 words of P (hi and lo): with addresses and masks, within its
    # 232 registers (255 at the wide widths)
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


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_tc_plan_fits_shared_memory(D):
    """Q tiles, the K/V ring and the barriers within the 227 KB a block may
    take (``tc::Cfg::kSmem``); D=256's two full-width Q tiles and 64-key
    ring take 193 KB."""
    p = fa.launch_plan(torch.bfloat16, 1, 100, 100, 8, 1, D)
    assert tc_smem_bytes(p) <= build.SMEM_LIMIT
    if D == 256:
        assert tc_smem_bytes(p) == 1024 + 2 * 32768 + 4 * 32768 + 8 * 9


@pytest.mark.parametrize("B,S,H,KV", [(2, 1535, 8, 1), (1, 4608, 16, 8), (1, 1, 8, 1),
                                      (3, 333, 8, 1), (2, 130, 4, 2), (1, 1000, 5, 1),
                                      (2, 77, 16, 16), (1, 4096, 16, 8)])
def test_tc_wide_grid_covers_every_position_once(B, S, H, KV):
    """At D=256 the grid is one axis: block x takes tile tiles - 1 - x // (KV
    * B) of kv head and batch x % (KV * B): every (position, kv head, batch)
    exactly once, no block without a row."""
    p = fa.launch_plan(torch.bfloat16, B, S, S, H, KV, 256)
    step = p["warpgroups"] * p["q_box"][2]
    tiles = -(-S // step)
    assert p["grid"] == (tiles * KV * B, 1, 1) and p["threads"] == 256
    seen = np.zeros((B, KV, S), int)
    for x in range(p["grid"][0]):
        tile, kvh, b = tc_block(p, S, KV, x)
        assert 0 <= tile * step < S and 0 <= kvh < KV and 0 <= b < B
        seen[b, kvh, tile * step:(tile + 1) * step] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,S,H,KV,window", [(2, 1535, 8, 1, None), (1, 4608, 16, 8, 4096),
                                             (4, 700, 8, 2, None)])
def test_tc_wide_grid_starts_the_longest_tiles(B, S, H, KV, window):
    """Blocks in launch order see non-increasing key ranges (causal, with
    the window): every (kv head, batch) of a tile before the next, shorter
    tile, so the last wave on the 132 SMs holds the shortest blocks."""
    p = fa.launch_plan(torch.bfloat16, B, S, S, H, KV, 256)
    step = p["warpgroups"] * p["q_box"][2]
    lengths = []
    for x in range(p["grid"][0]):
        tile, _, _ = tc_block(p, S, KV, x)
        lo, end = tile * step, min(S, (tile + 1) * step)
        lengths.append(end - (max(0, lo - window + 1) if window else 0))
    assert all(a >= b for a, b in zip(lengths, lengths[1:]))


def test_tc_wide_grid_at_gemma_prefill():
    """gemma-2b (MQA, G=8: 8 positions a warpgroup) and gemma2-9b (G=2)."""
    p = fa.launch_plan(torch.bfloat16, 2, 1535, 1535, 8, 1, 256)
    assert p["q_box"] == (64, 8, 8, 1) and p["grid"] == (192, 1, 1)
    assert p["key_tile"] == 64 and p["warpgroups"] == 2
    p = fa.launch_plan(torch.bfloat16, 1, 4608, 4608, 16, 8, 256)
    assert p["q_box"] == (64, 2, 32, 1) and p["grid"] == (576, 1, 1)


# the parent's plans (before the D=256 redesign) at the narrow shapes that the
# tests and chip_smoke.py use: (B, S, T, H, KV, D) -> (warpgroups, threads,
# key_tile, chunk, tile_width, q_box, grid)
NARROW_FLASH_PLANS = [
    ((4, 2048, 2048, 16, 8, 128), (2, 384, 64, 64, 128, (64, 2, 32, 1), (32, 8, 4))),
    ((2, 1535, 1535, 32, 32, 112), (2, 384, 64, 64, 128, (64, 1, 64, 1), (12, 32, 2))),
    ((2, 2111, 2111, 32, 32, 96), (2, 384, 64, 64, 128, (64, 1, 64, 1), (17, 32, 2))),
    ((2, 333, 333, 16, 8, 128), (2, 384, 64, 64, 128, (64, 2, 32, 1), (6, 8, 2))),
    ((2, 300, 300, 8, 8, 128), (2, 384, 64, 64, 128, (64, 1, 64, 1), (3, 8, 2))),
    ((2, 256, 256, 16, 2, 128), (2, 384, 64, 64, 128, (64, 8, 8, 1), (16, 2, 2))),
    ((2, 200, 200, 16, 8, 64), (2, 384, 64, 64, 64, (64, 2, 32, 1), (4, 8, 2))),
    ((2, 100, 180, 16, 8, 128), (2, 384, 64, 64, 128, (64, 2, 32, 1), (2, 8, 2))),
    ((1, 96, 96, 8, 8, 32), (2, 384, 64, 32, 32, (32, 1, 64, 1), (1, 8, 1))),
    ((1, 48, 16, 4, 4, 32), (2, 384, 64, 32, 32, (32, 1, 64, 1), (1, 4, 1))),
    ((8, 32, 32, 16, 8, 128), (2, 384, 64, 64, 128, (64, 2, 32, 1), (1, 8, 8))),
    ((2, 333, 333, 8, 8, 112), (2, 384, 64, 64, 128, (64, 1, 64, 1), (3, 8, 2))),
    ((2, 100, 180, 16, 8, 96), (2, 384, 64, 64, 128, (64, 2, 32, 1), (2, 8, 2))),
    ((1, 257, 257, 8, 4, 112), (2, 384, 64, 64, 128, (64, 2, 32, 1), (5, 4, 1))),
    ((1, 300, 300, 40, 8, 128), (2, 384, 64, 64, 128, (64, 5, 12, 1), (13, 8, 1))),
    ((1, 2048, 2048, 40, 8, 128), (2, 384, 64, 64, 128, (64, 5, 12, 1), (86, 8, 1))),
    ((2, 1535, 1535, 40, 8, 128), (2, 384, 64, 64, 128, (64, 5, 12, 1), (64, 8, 2))),
    ((2, 512, 512, 16, 16, 64), (2, 384, 64, 64, 64, (64, 1, 64, 1), (4, 16, 2))),
    ((2, 150, 150, 16, 2, 16), (2, 384, 64, 16, 16, (16, 8, 8, 1), (10, 2, 2))),
    ((1, 1000, 1000, 5, 1, 64), (2, 384, 64, 64, 64, (64, 5, 12, 1), (42, 1, 1))),
    ((1, 4096, 4096, 16, 8, 128), (2, 384, 64, 64, 128, (64, 2, 32, 1), (64, 8, 1))),
]


@pytest.mark.parametrize("shape,want", NARROW_FLASH_PLANS)
def test_launch_plan_is_the_parents_up_to_width_128(shape, want):
    wg, threads, key_tile, chunk, width, q_box, grid = want
    assert fa.launch_plan(torch.bfloat16, *shape) == {
        "route": "wgmma", "warpgroups": wg, "threads": threads, "stages": 2,
        "key_tile": key_tile, "chunk": chunk, "tile_width": width,
        "swizzle_bytes": 2 * chunk, "q_box": q_box, "kv_box": (chunk, 1, key_tile, 1),
        "grid": grid}


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


# the parent's split plans (before the byte-sized wide plan) at the narrow
# shapes that the tests and chip_smoke.py use: (B, KV, T, G, D, cache bytes)
# -> (n_split, heads_per_block, head_groups, lanes, pieces_per_lane, grid)
NARROW_SPLIT_PLANS = [
    ((4, 8, 2064, 2, 128, 2), (17, 2, 1, 16, 1, (17, 8, 4))),
    ((2, 32, 1543, 1, 112, 2), (9, 1, 1, 16, 1, (9, 32, 2))),
    ((2, 32, 2119, 1, 96, 2), (9, 1, 1, 16, 1, (9, 32, 2))),
    ((8, 8, 2048, 2, 128, 2), (9, 2, 1, 16, 1, (9, 8, 8))),
    ((1, 2, 32768, 1, 112, 2), (264, 1, 1, 16, 1, (264, 2, 1))),
    ((1, 32, 32768, 1, 112, 2), (17, 1, 1, 16, 1, (17, 32, 1))),
    ((2, 8, 1543, 5, 128, 2), (33, 8, 1, 16, 1, (33, 8, 2))),
    ((2, 16, 1543, 1, 128, 2), (17, 1, 1, 16, 1, (17, 16, 2))),
    ((2, 16, 1025, 1, 64, 2), (17, 1, 1, 8, 1, (17, 16, 2))),
    ((2, 2, 96, 4, 64, 2), (6, 4, 1, 8, 1, (6, 2, 2))),
    ((8, 32, 300, 1, 96, 2), (3, 1, 1, 16, 1, (3, 32, 8))),
    ((2, 8, 5000, 5, 128, 2), (33, 8, 1, 16, 1, (33, 8, 2))),
    ((1, 4, 7, 2, 32, 2), (1, 2, 1, 4, 1, (1, 4, 1))),
    ((6, 2, 2064, 8, 128, 2), (44, 8, 1, 16, 1, (44, 2, 6))),
    ((6, 2, 500, 5, 64, 2), (32, 8, 1, 8, 1, (32, 2, 6))),
    ((6, 2, 700, 2, 128, 4), (44, 2, 1, 32, 1, (44, 2, 6))),
    ((1, 8, 32768, 2, 128, 2), (66, 2, 1, 16, 1, (66, 8, 1))),
    ((2, 2, 100, 2, 16, 4), (7, 2, 1, 4, 1, (7, 2, 2))),
]


@pytest.mark.parametrize("shape,want", NARROW_SPLIT_PLANS)
def test_split_plan_is_the_parents_up_to_width_128(shape, want):
    """The parent's values, and the added keys at what the parent's kernel
    did: 16-slot chunks and the combine kernel."""
    n_split, hpb, groups, lanes, ppl, grid = want
    assert da.split_plan(*shape) == {
        "n_split": n_split, "heads_per_block": hpb, "head_groups": groups, "lanes": lanes,
        "lanes_log2": lanes.bit_length() - 1, "pieces_per_lane": ppl, "grid": grid,
        "min_chunk": da.CHUNK_ALIGN, "combine": "kernel"}


# gemma-2b's decode (B=2, MQA), gemma2-9b's global layer and its local ring,
# an f32 cache, one row of a long cache: (B, KV, T, G, D, cache bytes)
WIDE_SPLITS = [(2, 1, 1543, 8, 256, 2), (1, 8, 4616, 2, 256, 2), (1, 8, 4096, 2, 256, 2),
               (2, 2, 300, 4, 256, 4), (1, 1, 32768, 8, 256, 2), (6, 2, 300, 8, 256, 2)]


@pytest.mark.parametrize("B,KV,T,G,D,cb", WIDE_SPLITS)
def test_wide_split_plan_covers_every_valid_slot_once_in_its_minimum(B, KV, T, G, D, cb):
    """At D=256 every split of a row but its last holds at least
    ``min_chunk`` slots (16 KB of K), one head a block, the splits of a row cover its valid
    slots once, no block is spent past kv_len, and the last block merges at
    most MAX_MERGE_SPLITS partials."""
    p = da.split_plan(B, KV, T, G, D, cb)
    n, mc = p["n_split"], p["min_chunk"]
    assert p["combine"] == "last_block" and mc % da.CHUNK_ALIGN == 0
    assert p["heads_per_block"] == 1 and p["head_groups"] == G and p["pieces_per_lane"] == 2
    assert mc * D * cb >= da.WIDE_SPLIT_BYTES > (mc - da.CHUNK_ALIGN) * D * cb
    groups = B * KV * p["head_groups"]
    assert 1 <= n <= min(da.MAX_MERGE_SPLITS, -(-T // mc), -(-da.TARGET_BLOCKS // groups))
    for length in sorted({0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, T // 2 + 3, T - 1, T}):
        length = min(max(length, 0), T)
        c = da.row_chunk(length, n, mc)
        assert c >= mc and c % da.CHUNK_ALIGN == 0
        seen = np.zeros(T + c * n, int)
        for s in range(n):
            lo, hi = s * c, min((s + 1) * c, length)
            if lo < hi:
                seen[lo:hi] += 1
                assert hi - lo >= min(mc, length - lo)      # only a row's last split is short
        assert (seen[:length] == 1).all() and not seen[length:].any()
        assert -(-length // c) <= n


def test_wide_split_plan_at_gemma_decode():
    """One head a block and 16 lanes a row: gemma-2b 16 (row, head) groups
    of 33 splits of at least 32 slots (the parent's 2 groups of 97 splits
    of 16); gemma2-9b 16 (kv head, head) groups of 33 splits of 144 slots;
    both merged by the last block."""
    p = da.split_plan(2, 1, 1543, 8, 256, 2)
    assert p["grid"] == (33, 8, 2) and p["min_chunk"] == 32 and p["heads_per_block"] == 1
    assert (p["lanes"], p["pieces_per_lane"]) == (16, 2)
    assert -(-1536 // da.row_chunk(1536, 33, 32)) == 32
    assert -(-770 // da.row_chunk(770, 33, 32)) == 25
    p = da.split_plan(1, 8, 4616, 2, 256, 2)
    assert p["grid"] == (33, 16, 1) and da.row_chunk(4609, 33, 32) == 144
