"""The port's Mamba2 layer and hybrid model against the JAX package, on the CPU.

The layer (``models/ssm.py``) holds the reference's ``mamba2_init`` tree;
the chunked SSD forward, its final state, the one-token decode and the
conv buffer agree with the reference within 1e-4 (float32), the chunked form
equals the recurrence and is invariant to the chunk length (as
tests/test_models_core.py holds the reference), and the reference's chunk
rule (``L // chunk`` chunks that must tile L) raises in the port too.  The
reduced zamba2 (two groups' worth: one group of 2 Mamba layers and the
shared block, and a tail of 2) matches the reference's hidden states,
prefill logits, every cache entry (``ssm``, ``conv``, ``k``, ``v``,
``ssm_tail``, ``conv_tail``) and decode steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.models import ssm as jssm
from repro_torch.models import ssm

RNG = np.random.default_rng(7)


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    d_model: int = 32
    ssm_state: int = 16
    ssm_head_dim: int = 8
    norm_eps: float = 1e-6
    dtype: str = "float32"


def _layer(cfg, seed=0):
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), cfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in fam.tree_np(jp).items()}


def _x(*shape, scale=0.5):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_init_shapes_are_the_reference_shapes():
    cfg = SsmCfg()
    tp = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg)
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), cfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    # linspace's last bit differs between the two packages
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-6)
    assert ssm.ssm_dims(cfg) == jssm.ssm_dims(cfg)
    assert ssm.mamba2_state_shapes(cfg, 3) == jssm.mamba2_state_shapes(cfg, 3)


@pytest.mark.parametrize("L,chunk", [(32, 8), (32, 32), (24, 16), (48, 16)])
def test_apply_and_state_match_reference(L, chunk):
    cfg = SsmCfg()
    jp, tp = _layer(cfg)
    jx, tx = _x(2, L, cfg.d_model)
    jy, jh = jssm.mamba2_apply(jp, jx, cfg, chunk=chunk, return_state=True)
    ty, th = ssm.mamba2_apply(tp, tx, cfg, chunk=chunk, return_state=True)
    fam.close(ty, jy)
    fam.close(th, jh)


def test_initial_state_matches_reference():
    cfg = SsmCfg()
    jp, tp = _layer(cfg)
    jx, tx = _x(2, 16, cfg.d_model)
    h0 = RNG.standard_normal((2, 8, 8, 16)).astype(np.float32) * 0.1
    jy = jssm.mamba2_apply(jp, jx, cfg, chunk=8, initial_state=jnp.asarray(h0))
    fam.close(ssm.mamba2_apply(tp, tx, cfg, chunk=8, initial_state=torch.from_numpy(h0)), jy)


def test_decode_matches_reference():
    cfg = SsmCfg()
    jp, tp = _layer(cfg)
    d = ssm.ssm_dims(cfg)
    state = RNG.standard_normal((2, d.n_heads, d.head_dim, d.d_state)).astype(np.float32)
    buf = RNG.standard_normal((2, ssm.CONV_WIDTH - 1, d.conv_dim)).astype(np.float32)
    jx, tx = _x(2, 1, cfg.d_model)
    want = jssm.mamba2_decode(jp, jx, cfg, jnp.asarray(state), jnp.asarray(buf))
    got = ssm.mamba2_decode(tp, tx, cfg, torch.from_numpy(state), torch.from_numpy(buf))
    for g, w in zip(got, want):
        fam.close(g, w)


def test_chunked_equals_recurrent():
    cfg = SsmCfg()
    _, tp = _layer(cfg)
    _, x = _x(2, 32, cfg.d_model)
    y_chunk, hT = ssm.mamba2_apply(tp, x, cfg, chunk=8, return_state=True)
    d = ssm.ssm_dims(cfg)
    state = torch.zeros((2, d.n_heads, d.head_dim, d.d_state))
    buf = torch.zeros((2, ssm.CONV_WIDTH - 1, d.conv_dim))
    ys = []
    for t in range(32):
        yt, state, buf = ssm.mamba2_decode(tp, x[:, t:t + 1], cfg, state, buf)
        ys.append(yt)
    fam.close(y_chunk, torch.cat(ys, 1), 2e-3)
    fam.close(hT, state, 2e-3)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunk_size_invariance(chunk):
    cfg = SsmCfg()
    _, tp = _layer(cfg, seed=1)
    _, x = _x(1, 32, cfg.d_model)
    base = ssm.mamba2_apply(tp, x, cfg, chunk=32)
    np.testing.assert_allclose(ssm.mamba2_apply(tp, x, cfg, chunk=chunk).numpy(),
                               base.numpy(), atol=2e-4)


@pytest.mark.parametrize("L,chunk", [(30, 8), (1535, 256), (17, 16)])
def test_chunk_rule_raises_as_the_reference(L, chunk):
    """L // chunk chunks of L // (L // chunk) must tile L: 30 = 3 x 10 does
    and runs; 1535 (5 x 307) runs; 17 (1 chunk of 17) runs; 31 at 8 does not."""
    cfg = SsmCfg()
    jp, tp = _layer(cfg)
    jx, tx = _x(1, L, cfg.d_model)
    fam.close(ssm.mamba2_apply(tp, tx, cfg, chunk=chunk),
              jssm.mamba2_apply(jp, jx, cfg, chunk=chunk))


@pytest.mark.parametrize("L,chunk", [(31, 8), (1537, 256), (50, 16)])
def test_chunk_rule_failure(L, chunk):
    cfg = SsmCfg()
    jp, tp = _layer(cfg)
    jx, tx = _x(1, L, cfg.d_model)
    with pytest.raises(AssertionError, match="not divisible"):
        jssm.mamba2_apply(jp, jx, cfg, chunk=chunk)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.mamba2_apply(tp, tx, cfg, chunk=chunk)


def test_segsum_is_zero_above_the_diagonal_after_exp():
    x = torch.from_numpy(RNG.standard_normal((3, 6)).astype(np.float32))
    got = torch.exp(ssm._segsum(x))
    assert (torch.triu(got, 1) == 0).all() and (torch.diagonal(got, dim1=-2, dim2=-1) == 1).all()
    fam.close(got, jnp.exp(jssm._segsum(jnp.asarray(x.numpy()))), 1e-5)


# ------------------------------------------------------------------ hybrid
ARCH = "zamba2-7b"


def test_hidden_states():
    jcfg, jm, params, tm = fam.pair(ARCH)
    tok = fam.tokens(2, 32, jcfg.vocab_size, 1)
    fam.close(tm.hidden_states({"tokens": torch.from_numpy(tok)}),
              jm.hidden_states(params, {"tokens": jnp.asarray(tok)}))


@pytest.mark.parametrize("S,extra", [(16, 0), (24, 8), (32, 4), (13, 3)])
def test_prefill_logits_and_cache(S, extra):
    """S a chunk (16), 1.5 chunks (24: one chunk of 24), two chunks (32) and
    a ragged prompt (13)."""
    jcfg, jm, params, tm = fam.pair(ARCH)
    tok = fam.tokens(2, S, jcfg.vocab_size, 2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tok)}, S + extra,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tok)}, S + extra,
                        cache_dtype=torch.float32)
    fam.close(tl, jl)
    fam.close_cache(tc, jc)


def test_decode_step_after_prefill():
    jcfg, jm, params, tm = fam.pair(ARCH)
    S = 16
    tok = fam.tokens(2, S + 3, jcfg.vocab_size, 3)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :S])}, S + 8,
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
    S = 15
    tok = torch.from_numpy(fam.tokens(2, S + 1, jcfg.vocab_size, 7))
    _, cache = tm.prefill({"tokens": tok[:, :S]}, S + 8, cache_dtype=torch.float32)
    got, _ = tm.decode_step(tok[:, S:], cache, S)
    fam.close(got, tm.prefill({"tokens": tok}, S + 8, cache_dtype=torch.float32)[0])
    hidden = tm.hidden_states({"tokens": tok})
    fam.close(got, tm.logits(hidden[:, -1:]))


def test_each_shared_application_keeps_its_cache():
    """One parameter set, one KV cache per application (G groups)."""
    jcfg, _, _, tm = fam.pair(ARCH, (("n_layers", 7), ("attn_every", 2)))
    assert (tm.n_groups, tm.period, tm.n_tail) == (3, 2, 1)
    tok = torch.from_numpy(fam.tokens(1, 12, jcfg.vocab_size, 4))
    _, cache = tm.prefill({"tokens": tok}, 16, cache_dtype=torch.float32)
    assert cache["k"].shape[0] == 3 and not torch.equal(cache["k"][0], cache["k"][1])
    assert sum(1 for n, _ in tm.named_parameters() if n.startswith("shared.attn.")) == 4
