"""The port's encoder-decoder model against the JAX package, on the CPU.

The reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, float32,
the JAX ``init(PRNGKey(0))`` tree converted) encodes the same numpy frames
and decodes the same tokens: the encoder memory, the decoder's hidden
states, prefill logits, every cache entry (``k``, ``v``, ``xk``, ``xv``)
and decode steps agree within 1e-4.  In the port every attention call is a
kernel op: the encoder's self-attention K6 without a causal mask, the
cross-attention K6 at prefill (S decoder positions against T frames, S != T)
and K7 at decode against the whole memory, the decoder's self-attention K6 /
K7.  A prefill without ``frames`` fails with the reference's KeyError.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro_torch.kernels import ops

ARCH = "seamless-m4t-large-v2"


def _frames(B, T, d, seed):
    x = (np.random.default_rng(seed).standard_normal((B, T, d)) * 0.02).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("T", [8, 13])
def test_encode_and_decode_full(T):
    jcfg, jm, params, tm = fam.pair(ARCH)
    jf, tf = _frames(2, T, jcfg.d_model, 1)
    jmem, tmem = jm.encode(params, jf), tm.encode(tf)
    fam.close(tmem, jmem)
    tok = fam.tokens(2, 10, jcfg.vocab_size, 1)
    want = jm.decode_full(params, jnp.asarray(tok), jmem)
    got = tm.decode_full(torch.from_numpy(tok), tmem)
    fam.close(got, want)
    fam.close(tm.logits(got), jm.logits(params, want))


@pytest.mark.parametrize("S,T,extra", [(10, 8, 4), (16, 24, 0), (7, 13, 8)])
def test_prefill_logits_and_cache(S, T, extra):
    jcfg, jm, params, tm = fam.pair(ARCH)
    jf, tf = _frames(2, T, jcfg.d_model, 2)
    tok = fam.tokens(2, S, jcfg.vocab_size, 2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tok), "frames": jf}, S + extra,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tok), "frames": tf}, S + extra,
                        cache_dtype=torch.float32)
    fam.close(tl, jl)
    fam.close_cache(tc, jc)


def test_decode_step_after_prefill():
    jcfg, jm, params, tm = fam.pair(ARCH)
    S = 10
    jf, _ = _frames(2, 8, jcfg.d_model, 3)
    tok = fam.tokens(2, S + 3, jcfg.vocab_size, 3)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :S]), "frames": jf}, S + 8,
                       cache_dtype=jnp.float32)
    cache = fam.port_cache(jc)
    for step in range(3):
        nxt = tok[:, S + step:S + step + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jnp.int32(S + step))
        tl, cache = tm.decode_step(torch.from_numpy(nxt), cache, S + step)
        fam.close(tl, jl)
        fam.close_cache(cache, jc)


def test_decode_equals_longer_prefill():
    jcfg, _, _, tm = fam.pair(ARCH)
    S = 11
    _, tf = _frames(2, 9, jcfg.d_model, 7)
    tok = torch.from_numpy(fam.tokens(2, S + 1, jcfg.vocab_size, 7))
    _, cache = tm.prefill({"tokens": tok[:, :S], "frames": tf}, S + 4,
                          cache_dtype=torch.float32)
    got, _ = tm.decode_step(tok[:, S:], cache, S)
    want, _ = tm.prefill({"tokens": tok, "frames": tf}, S + 4, cache_dtype=torch.float32)
    fam.close(got, want)


def test_attention_goes_through_the_kernel_ops(monkeypatch):
    """Prefill: 2 encoder + 2 self + 2 cross K6 calls, the cross ones with
    S != T and no causal mask; a decode step: 2 self + 2 cross K7 calls, the
    cross ones with kv_len = the encoder length."""
    jcfg, _, _, tm = fam.pair(ARCH)
    calls = {"flash": [], "decode": []}
    flash, decode = ops.flash_attention, ops.decode_attention

    def rec_flash(q, k, v, **kw):
        calls["flash"].append((q.shape[1], k.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)

    def rec_decode(q, k, v, kv_len, **kw):
        calls["decode"].append((k.shape[1], kv_len.tolist()))
        return decode(q, k, v, kv_len, **kw)

    monkeypatch.setattr(ops, "flash_attention", rec_flash)
    monkeypatch.setattr(ops, "decode_attention", rec_decode)
    _, tf = _frames(2, 13, jcfg.d_model, 4)
    tok = torch.from_numpy(fam.tokens(2, 6, jcfg.vocab_size, 4))
    _, cache = tm.prefill({"tokens": tok, "frames": tf}, 10, cache_dtype=torch.float32)
    assert calls["flash"] == [(13, 13, False)] * 2 + [(6, 6, True), (6, 13, False)] * 2
    tm.decode_step(tok[:, :1], cache, 6)
    assert calls["decode"] == [(10, [7, 7]), (13, [13, 13])] * 2


def test_prefill_without_frames_raises_as_the_reference():
    jcfg, jm, params, tm = fam.pair(ARCH)
    tok = fam.tokens(1, 4, jcfg.vocab_size, 5)
    with pytest.raises(KeyError, match="frames"):
        jm.prefill(params, {"tokens": jnp.asarray(tok)}, 8)
    with pytest.raises(KeyError, match="frames"):
        tm.prefill({"tokens": torch.from_numpy(tok)}, 8)
