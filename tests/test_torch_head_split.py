"""The rank-local attention of a model axis that splits q's heads unevenly.

``ops.head_slice_attention`` is what each rank of "model" runs on its own
q heads [h0, h1), in DTensor's chunks (ceil(H / m) a rank, the last ranks
fewer or none), against all the kv heads.  Here, on the CPU (K6's plain
version), every slice of a split is run and the slices are put together:
concatenated over the heads they are the reference's ``attn_core`` on the
same numpy-seeded inputs (H=10 over KV=2 on 4 and on 16 ranks, f32, 2e-5);
their gradients (dQ concatenated, dK and dV summed over the slices) are
the whole call's within 1e-5.  A rank without heads launches nothing and
records no work.  The vocabulary's chunks go through the functions a rank
runs for its logits and its share of the cross entropy, against the
reference's logsumexp and gold logit.  The 4-rank DTensor cases are in test_torch_layout_dist.py;
rank 0's accounting in a fake world of 256 ranks in
``tests/torch_head_fake_world.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models.attention import attn_core as j_attn_core
from repro.models.layers import softcap as j_softcap
from repro_torch.kernels import build, flash_attention, ops
from repro_torch.models import layers
from repro_torch.models.partitioning import _chunks, _spans

ROOT = Path(__file__).resolve().parents[1]


class _Cfg:
    attn_logit_softcap = None
    query_pre_attn_scalar = None


def test_split_follows_dtensor_chunks():
    """The splits of the full configs' shapes: 40 heads over 16 (3 a rank on
    ranks 0-12, 1 on 13, none on 14-15), 8 over 16 (1 on ranks 0-7), 256206
    vocabulary rows over 16 (ceil(256206 / 16) = 16013, the last 16011)."""
    assert _chunks(40, 16) == [3] * 13 + [1, 0, 0]
    assert _chunks(8, 16) == [1] * 8 + [0] * 8
    assert _chunks(256206, 16) == [16013] * 15 + [16011]
    # K6's calls (first kv head, kv heads, q heads): llama4's rank 1, heads
    # 3, 4, 5 reading kv heads 0, 0, 1 (G = 5), two calls; rank 13, one head;
    # whole groups, one call; rank 14, none
    assert ops.head_slice_calls(3, 6, 5) == [(0, 1, 2), (1, 1, 1)]
    assert ops.head_slice_calls(39, 40, 5) == [(7, 1, 1)]
    assert ops.head_slice_calls(0, 10, 5) == [(0, 2, 10)]
    assert ops.head_slice_calls(40, 40, 5) == []
    assert all(len(ops.head_slice_calls(h0, h1, 5)) <= -(-(h1 - h0) // 5) + 1
               for h0 in range(40) for h1 in range(h0, 41))


@pytest.mark.parametrize("m", [4, 16])
def test_slices_match_the_reference(m):
    """H=10, KV=2 (G=5) split over m ranks (4: 3, 3, 3, 1 heads, two slices
    straddling the kv groups; 16: one head on ranks 0-9, none on 10-15):
    the slices, concatenated, against the reference's ``attn_core``."""
    B, S, H, KV, D = 2, 24, 10, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = np.asarray(j_attn_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=_Cfg))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = torch.cat([ops.head_slice_attention(tq[:, :, h0:h1], tk, tv, h0, H)
                     for h0, h1 in _spans(H, m)], dim=2)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("H,KV,m,kw", [
    (10, 2, 4, {}),
    (40, 8, 16, {"q_offset": 3}),             # llama4's split (G = 5), a chunk's offset
    (8, 1, 16, {"window": 7}),                # gemma-2b's: one kv head, ranks 8-15 empty
    (9, 3, 2, {"softcap": 20.0}),             # 5 and 4 heads, rank 0 straddling
])
def test_slice_gradients_match_one_call(H, KV, m, kw):
    """Forward and gradients of the slices against one whole call: dQ
    concatenated, dK and dV summed over the slices, within 1e-5 (relative
    to the largest value); each slice's K6 calls take its own heads only."""
    B, S, D = 2, 16, 16
    T = S + kw.get("q_offset", 0)
    rng = np.random.default_rng(1)
    q, w = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, KV, D)).astype(np.float32))
            for _ in range(2))
    whole = [x.clone().requires_grad_() for x in (q, k, v)]
    (ops.flash_attention(*whole, **kw) * w).sum().backward()
    want = ops.flash_attention(q, k, v, **kw)
    heads, forward = [], flash_attention.forward

    def logging(q_, *args, **kw_):
        if q_.shape[2]:     # an empty slice's call returns before any launch
            heads.append(q_.shape[2])
        return forward(q_, *args, **kw_)

    parts, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    flash_attention.forward = logging
    try:
        for h0, h1 in _spans(H, m):
            ql = q[:, :, h0:h1].clone().requires_grad_()
            kl, vl = k.clone().requires_grad_(), v.clone().requires_grad_()
            out = ops.head_slice_attention(ql, kl, vl, h0, H, **kw)
            assert out.shape == (B, S, h1 - h0, D)
            (out * w[:, :, h0:h1]).sum().backward()
            parts.append((out.detach(), ql.grad))
            dk, dv = dk + kl.grad, dv + vl.grad
    finally:
        flash_attention.forward = forward
    assert heads == [n for h0, h1 in _spans(H, m)
                     for _, _, n in ops.head_slice_calls(h0, h1, H // KV)]
    assert max(heads) <= -(-H // m)
    for got, ref in ((torch.cat([o for o, _ in parts], dim=2), want),
                     (torch.cat([g for _, g in parts], dim=2), whole[0].grad),
                     (dk, whole[1].grad), (dv, whole[2].grad)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_empty_slice_launches_nothing():
    """No q head: an empty output without work, even on fake tensors (what a
    dry run's rank 14 of llama4 sees), and a zero gradient for k and v."""
    B, S, D = 1, 8, 16
    seen = []
    with build.observe_work(lambda *a: seen.append(a)), FakeTensorMode():
        q = torch.empty(B, S, 0, D, dtype=torch.bfloat16)
        k = torch.empty(B, S, 8, D, dtype=torch.bfloat16)
        out = ops.head_slice_attention(q, k, k, 45, 40)
        assert out.shape == (B, S, 0, D)
    assert seen == []
    k = torch.randn(B, S, 2, D, requires_grad=True)
    q = torch.randn(B, S, 0, D, requires_grad=True)
    ops.head_slice_attention(q, k, k, 10, 10).sum().backward()
    assert k.grad is not None and not k.grad.any()


def test_fake_world_rank0_holds_its_share():
    """Rank 0 of a 16 x 16 fake world (``tests/torch_head_fake_world.py``):
    llama4's attention layer (40 heads, 8 kv heads, d=5120) forward and
    backward, and seamless's cross entropy (256206 rows, d=1024): no K6 call
    with more than 3 q heads, logits of 16013 vocabulary columns, no product
    with all 256206, no (5120, 5120) product, q and the output moved by
    all-to-all."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(Path(__file__).with_name(
        "torch_head_fake_world.py"))], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["k6_heads"] == [3], got
    assert got["max_vocab_cols"] == 16013, got
    assert [5120, 5120] not in got["mm_shapes"], got["mm_shapes"]
    assert not any(256206 in s for s in got["mm_shapes"]), got["mm_shapes"]
    assert got["all_to_all"] > 0, got


@pytest.mark.parametrize("m,cap", [(4, None), (16, 30.0)])
def test_vocab_chunks_match_the_reference(m, cap):
    """A vocabulary of 257 rows cut into m chunks (16: 17 rows a rank, 2 on
    the last), each through what a rank of "model" runs: its logits
    ``layers.vocab_chunk(h, w[v0:v1])``, its max (``chunk_max``), maxed
    over the chunks, its exp-sum and gold logit (``chunk_sum_gold``),
    summed over them; against the reference's soft-capped f32 logits,
    ``jax.nn.logsumexp`` and the labels' logits (f32, 1e-5)."""
    N, d, V = 12, 16, 257
    rng = np.random.default_rng(2)
    h = rng.standard_normal((N, d)).astype(np.float32)
    w = rng.standard_normal((V, d)).astype(np.float32)
    labels = rng.integers(0, V, N)
    logits = j_softcap((jnp.asarray(h) @ jnp.asarray(w).T).astype(jnp.float32), cap)
    want_lse = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    want_gold = np.asarray(jnp.take_along_axis(logits, jnp.asarray(labels)[:, None], -1)[:, 0])
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels)
    spans = _spans(V, m)
    chunks = [layers.vocab_chunk(th, tw[v0:v1], cap) for v0, v1 in spans]
    assert [c.shape[-1] for c in chunks] == _chunks(V, m)
    mx = torch.stack([layers.chunk_max(c) for c in chunks]).amax(dim=0)
    parts = [layers.chunk_sum_gold(c, tl, v0, mx) for c, (v0, _) in zip(chunks, spans)]
    lse = mx + torch.log(sum(s for s, _ in parts))
    gold = sum(g for _, g in parts)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gold.numpy(), want_gold, atol=1e-5, rtol=0)
    whole = layers.lse_gold(layers.vocab_logits(th, tw, cap), tl)
    np.testing.assert_allclose(whole[0].numpy(), want_lse, atol=1e-5, rtol=0)
    np.testing.assert_allclose(whole[1].numpy(), want_gold, atol=1e-5, rtol=0)
