"""K7 on a cache sharded over its slots (context parallelism), on the CPU.

* ``ref.decode_attention_ref(..., return_lse=True)``: the output against
  the reference's Pallas ``decode_attention`` (interpret mode, at multiples
  of its block) and the log-sum-exp against the reference's own logits
  (``repro.kernels.ref``'s math in JAX), within 1e-5, rows with no valid
  slot included (lse = -inf, output 0).
* The split-and-combine of ``ops.sharded_decode_attention`` emulated on one
  device: the cache cut into 2, 4 and 16 shards (DTensor's chunks, even and
  uneven; shards with no valid slot and ragged ``kv_len`` among them), K7
  with ``return_lse`` on each and ``decode_attention.combine`` over the
  stacked shards, within 1e-5 of the reference's ``decode_attention``.
* On 4 gloo ranks (``tests/torch_layout_worker.py``, a (2, 2) ("data",
  "model") mesh): reduced qwen3, zamba2 and seamless take a prefill and 3
  decode steps on DTensors, parameters placed by ``state_shardings``
  ("fsdp"), the cache as ``cache_shardings`` places it (slots over "model",
  so that some steps find a shard with no valid slot); each step's logits
  within 1e-5 of one device's and of the reference's ``decode_step``, the
  cache's placements kept; zamba2's Mamba2 layers split their heads over
  "model", and after the prefill and each step every rank's chunk of each
  conv buffer (its batch rows, its 80 of 160 channels) within 1e-5 of one
  device's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as decode_k
from repro_torch.kernels import ref
from test_torch_layout_dist import _run

TOL = 1e-5
RNG = np.random.default_rng(24)


def _inputs(B, T, H, KV, D, lens):
    q, k, v = (RNG.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, T, KV, D), (B, T, KV, D)))
    return q, k, v, np.asarray(lens, np.int32)


def _ref_lse(q, k, lens, scale, softcap):
    """The log-sum-exp of the reference's masked logits (its oracle's math)."""
    B, H, D = q.shape
    KV = k.shape[2]
    qg = jnp.asarray(q).reshape(B, KV, H // KV, D)
    logits = jnp.einsum("bkgd,btkd->bkgt", qg, jnp.asarray(k)) * scale
    if softcap is not None:
        logits = softcap * jnp.tanh(logits / softcap)
    mask = jnp.arange(k.shape[1])[None, :] < jnp.asarray(lens)[:, None]
    lse = jax.nn.logsumexp(jnp.where(mask[:, None, None, :], logits, -jnp.inf), axis=-1)
    return np.asarray(lse.reshape(B, H))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_lse_against_the_reference(softcap):
    B, T, H, KV, D = 4, 64, 8, 2, 32
    q, k, v, lens = _inputs(B, T, H, KV, D, [64, 33, 1, 0])
    scale = 0.125
    out, lse = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, lens)), scale=scale,
                                        softcap=softcap, return_lse=True)
    want = jops.decode_attention(*map(jnp.asarray, (q, k, v, lens)), softcap=softcap,
                                 scale=scale, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, lens, scale, softcap),
                               atol=TOL, rtol=TOL)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert bool(torch.isneginf(lse[3]).all()) and not bool(out[3].any())
    # the wrapper on CPU tensors runs this plain version, lse included
    got, got_lse = decode_k.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                                             scale=scale, softcap=softcap, return_lse=True)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=0)


def _chunks(T: int, n: int):
    """DTensor's cut of T slots into n shards: chunks of ceil(T / n), the
    last ones shorter or empty."""
    c = -(-T // n)
    return [(min(r * c, T), min((r + 1) * c, T)) for r in range(n)]


@pytest.mark.parametrize("n,T,lens", [(2, 64, [64, 40, 31, 1]), (4, 64, [64, 17, 16, 0]),
                                      (16, 64, [64, 5, 33, 62]), (4, 66, [66, 50, 2, 17]),
                                      (16, 40, [40, 37, 3, 9])])
def test_split_and_combine_matches_one_call(n, T, lens):
    """n shards of T slots (T = 66 over 4 and 40 over 16: uneven, the last
    shards short or empty), ragged kv_len (0 in a row: every shard empty)."""
    B, H, KV, D = 4, 8, 2, 16
    q, k, v, lens_np = _inputs(B, T, H, KV, D, lens)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens_np))
    outs, lses = [], []
    for t0, t1 in _chunks(T, n):
        o, s = decode_k.decode_attention(tq.float(), tk[:, t0:t1], tv[:, t0:t1],
                                         (tl - t0).clamp(0, t1 - t0).to(torch.int32),
                                         return_lse=True)
        outs.append(o)
        lses.append(s)
    got = decode_k.combine(torch.stack(outs), torch.stack(lses),
                           lambda x: x.amax(0, keepdim=True), lambda x: x.sum(0))
    block = 8 if T % 8 == 0 else 2   # the Pallas kernel reads whole blocks
    want = jops.decode_attention(*map(jnp.asarray, (q, k, v, lens_np)), block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.decode_attention_ref(
        *map(jnp.asarray, (q, k, v, lens_np)))) * (lens_np > 0)[:, None, None],
        atol=TOL, rtol=TOL)


# ------------------------------------------------------------- 4 gloo ranks
CASES = {"qwen3-1.7b": (4, 12, 0), "zamba2-7b": (16, 20, 0),
         "seamless-m4t-large-v2": (4, 12, 8)}


def _reference(arch: str, batch: int = 2, case=None):
    """(jax logits of the prefill and each step, the port's on one device,
    what the ranks load): ``batch`` rows, prompt S, a cache of max_len
    slots, 3 steps ((S, max_len, frames) from ``case``, else CASES)."""
    S, max_len, n_frames = case or CASES[arch]
    jcfg, jm, params, tm = fam.pair(arch)
    tok = fam.tokens(batch, S + 3, jcfg.vocab_size, 5)
    jb, tb = fam.batches(jcfg, tok[:, :S], seed=6, n_frames=n_frames)
    jl, jc = jm.prefill(params, jb, max_len, cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tb, max_len, cache_dtype=torch.float32)
    want, one = [np.asarray(jl)], [tl.numpy()]
    convs = [{k: t.numpy().copy() for k, t in tc.items() if k.startswith("conv")}]
    for step in range(3):
        nxt = tok[:, S + step:S + step + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jnp.int32(S + step))
        tl, tc = tm.decode_step(torch.from_numpy(nxt), tc, S + step)
        want.append(np.asarray(jl))
        one.append(tl.numpy())
        convs.append({k: t.numpy().copy() for k, t in tc.items() if k.startswith("conv")})
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    data = {"params": {n: p.detach().clone() for n, p in tm.named_parameters()},
            "tokens": torch.from_numpy(tok), "S": S, "steps": 3, "max_len": max_len,
            "extra": extra}
    return want, one, convs, data


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_decode_matches_one_device(arch, tmp_path):
    want, one, convs, data = _reference(arch)
    torch.save(data, tmp_path / "decode_in.pt")
    for r, res in enumerate(_run(f"decode:{arch}", tmp_path)):
        assert res["bad"] == [], (r, res["bad"][:5])
        assert res["seq_sharded"], res            # some cache is sharded over its slots
        for step, (got, w, o) in enumerate(zip(res["logits"], want, one)):
            got = np.asarray(got, np.float32)
            np.testing.assert_allclose(got, o, atol=TOL, rtol=TOL, err_msg=f"rank {r} {step}")
            np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL, err_msg=f"rank {r} {step}")
        assert len(res["conv_chunks"]) == len(convs)
        for step, (chunks, whole) in enumerate(zip(res["conv_chunks"], convs)):
            assert sorted(chunks) == sorted(whole)
            for k, c in chunks.items():
                local = np.asarray(c["local"], np.float32)
                assert local.shape[-1] < whole[k].shape[-1], (k, local.shape)   # split channels
                at = tuple(slice(o, o + n) for o, n in zip(c["offset"], local.shape))
                np.testing.assert_allclose(local, whole[k][at], atol=TOL, rtol=TOL,
                                           err_msg=f"rank {r} {k} {step}")
