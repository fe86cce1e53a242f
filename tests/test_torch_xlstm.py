"""The port's mLSTM/sLSTM blocks and xLSTM model against the JAX package, on
the CPU.

The blocks (``models/xlstm.py``) hold the reference's ``mlstm_init`` /
``slstm_init`` trees: the parallel and chunked mLSTM forms, the one-step
recurrence, prefill (with the exact final (C, n, m) state and the conv
buffer) and decode, and the sLSTM scan, prefill and decode agree with the
reference within 1e-4 (float32).  Mirrored from tests/test_models_core.py:
chunked equals parallel, the chunked state equals the recurrence, and the
``mlstm_impl`` switch changes nothing at the model level.  The reduced
xlstm-125m (two groups of 3 mLSTM blocks and one sLSTM block) matches the
reference's hidden states, prefill logits, every cache entry (``mC`` ..
``sbuf``) and decode steps; its decode ignores ``pos``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.models import xlstm as jx
from repro_torch.models import xlstm

RNG = np.random.default_rng(7)


@dataclasses.dataclass(frozen=True)
class XCfg:
    d_model: int = 64
    n_heads: int = 4
    norm_eps: float = 1e-6
    dtype: str = "float32"
    mlstm_impl: str = "quadratic"
    scan_chunk: int = 16


def _arr(*shape, scale=1.0, shift=0.0):
    x = (RNG.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _qkv(B=2, L=48, H=4, D=16):
    """(jax, port) q, k, v, log input gate, log forget gate."""
    pairs = [_arr(B, L, H, D) for _ in range(3)] + [_arr(B, L, H)]
    jf, tf = _arr(B, L, H, shift=2.0)
    pairs.append((jax.nn.log_sigmoid(jf), torch.nn.functional.logsigmoid(tf)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _params(init, cfg, seed=0):
    jp = init(jax.random.PRNGKey(seed), cfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in fam.tree_np(jp).items()}


def test_init_shapes_are_the_reference_shapes():
    cfg = XCfg()
    gen = torch.Generator().manual_seed(0)
    for tinit, jinit in ((xlstm.mlstm_init, jx.mlstm_init), (xlstm.slstm_init, jx.slstm_init)):
        tp, jp = tinit(gen, cfg), jinit(jax.random.PRNGKey(0), cfg)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
        for k in ("b_if", "b"):
            if k in jp:
                np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert xlstm.mlstm_state_shapes(cfg, 3) == jx.mlstm_state_shapes(cfg, 3)
    assert xlstm.slstm_state_shapes(cfg, 3) == jx.slstm_state_shapes(cfg, 3)


def test_parallel_matches_reference():
    j, t = _qkv()
    fam.close(xlstm.mlstm_parallel(*t), jx.mlstm_parallel(*j))


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunked_matches_reference_and_parallel(chunk):
    j, t = _qkv()
    got, state = xlstm.mlstm_chunked(*t, chunk=chunk, return_state=True)
    want, jstate = jx.mlstm_chunked(*j, chunk=chunk, return_state=True)
    fam.close(got, want)
    for a, b in zip(state, jstate):
        fam.close(a, b)
    fam.close(got, xlstm.mlstm_parallel(*t))


def test_chunked_state_matches_recurrence():
    _, (q, k, v, li, lf) = _qkv(L=24)
    _, (C, n, m) = xlstm.mlstm_chunked(q, k, v, li, lf, chunk=8, return_state=True)
    st = (torch.zeros((2, 4, 16, 16)), torch.zeros((2, 4, 16)), torch.full((2, 4), -1e30))
    for t in range(24):
        _, st = xlstm.mlstm_step(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], st)
    for a, b in zip((C, n, m), st):
        fam.close(a, b)


def test_step_matches_reference():
    (jq, jk, jv, jli, jlf), (q, k, v, li, lf) = _qkv(L=1)
    st = [_arr(2, 4, 16, 16), _arr(2, 4, 16), _arr(2, 4)]
    jh, jst = jx.mlstm_step(jq[:, 0], jk[:, 0], jv[:, 0], jli[:, 0], jlf[:, 0],
                            tuple(s[0] for s in st))
    th, tst = xlstm.mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0],
                               tuple(s[1] for s in st))
    fam.close(th, jh)
    for a, b in zip(tst, jst):
        fam.close(a, b)


def test_chunk_rule_raises_as_the_reference():
    """20 at chunk 8 is 2 chunks of 10 and runs; at chunk 6, 3 x 6 != 20."""
    j, t = _qkv(L=20)
    fam.close(xlstm.mlstm_chunked(*t, chunk=8), jx.mlstm_chunked(*j, chunk=8))
    with pytest.raises(AssertionError):
        jx.mlstm_chunked(*j, chunk=6)
    with pytest.raises(ValueError, match="not divisible"):
        xlstm.mlstm_chunked(*t, chunk=6)


@pytest.mark.parametrize("impl", ["quadratic", "chunked"])
def test_mlstm_prefill_and_decode_match_reference(impl):
    cfg = XCfg(mlstm_impl=impl, scan_chunk=8)
    jp, tp = _params(jx.mlstm_init, cfg)
    jxs, txs = _arr(2, 24, cfg.d_model, scale=0.5)
    fam.close(xlstm.mlstm_apply(tp, txs, cfg), jx.mlstm_apply(jp, jxs, cfg))
    jy, jst, jbuf = jx.mlstm_prefill(jp, jxs, cfg)
    ty, tst, tbuf = xlstm.mlstm_prefill(tp, txs, cfg)
    for a, b in zip((ty, *tst, tbuf), (jy, *jst, jbuf)):
        fam.close(a, b)
    j1, t1 = _arr(2, 1, cfg.d_model, scale=0.5)
    want = jx.mlstm_decode(jp, j1, cfg, jst, jbuf)
    got = xlstm.mlstm_decode(tp, t1, cfg, tst, tbuf)
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        fam.close(a, b)


def test_slstm_scan_prefill_decode_match_reference():
    cfg = XCfg()
    jp, tp = _params(jx.slstm_init, cfg)
    jxs, txs = _arr(2, 20, cfg.d_model, scale=0.5)
    jh, jfin = jx.slstm_scan(jp, jxs, cfg)
    th, tfin = xlstm.slstm_scan(tp, txs, cfg)
    for a, b in zip((th, *tfin), (jh, *jfin)):
        fam.close(a, b)
    fam.close(xlstm.slstm_apply(tp, txs, cfg), jx.slstm_apply(jp, jxs, cfg))
    jy, jst, jbuf = jx.slstm_prefill(jp, jxs, cfg)
    ty, tst, tbuf = xlstm.slstm_prefill(tp, txs, cfg)
    for a, b in zip((ty, *tst, tbuf), (jy, *jst, jbuf)):
        fam.close(a, b)
    j1, t1 = _arr(2, 1, cfg.d_model, scale=0.5)
    want = jx.slstm_decode(jp, j1, cfg, jst, jbuf)
    got = xlstm.slstm_decode(tp, t1, cfg, tst, tbuf)
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        fam.close(a, b)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default, which the sLSTM block's MLP uses."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


# ------------------------------------------------------------------- model
ARCH = "xlstm-125m"
CASES = {"quadratic": (ARCH, ()),
         "chunked": (ARCH, (("mlstm_impl", "chunked"), ("scan_chunk", 8)))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hidden_states(case):
    jcfg, jm, params, tm = fam.pair(*CASES[case])
    tok = fam.tokens(2, 32, jcfg.vocab_size, 1)
    fam.close(tm.hidden_states({"tokens": torch.from_numpy(tok)}),
              jm.hidden_states(params, {"tokens": jnp.asarray(tok)}))


def test_model_level_impl_switch():
    """The whole model: chunked == quadratic (tests/test_models_core.py)."""
    _, _, _, quad = fam.pair(*CASES["quadratic"])
    _, _, _, chunked = fam.pair(*CASES["chunked"])
    tok = {"tokens": torch.from_numpy(fam.tokens(2, 32, quad.cfg.vocab_size, 5))}
    fam.close(chunked.hidden_states(tok), quad.hidden_states(tok))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_and_cache(case):
    jcfg, jm, params, tm = fam.pair(*CASES[case])
    tok = fam.tokens(2, 24, jcfg.vocab_size, 2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tok)}, 0, cache_dtype=jnp.float32)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tok)}, 0, cache_dtype=torch.float32)
    fam.close(tl, jl)
    fam.close_cache(tc, jc)
    empty = tm.init_cache(3)
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: v.shape for k, v in jm.init_cache(3).items()}
    assert (empty["mm"] == -1e30).all() and (empty["sm"] == -10.0).all()


def test_decode_step_after_prefill():
    jcfg, jm, params, tm = fam.pair(ARCH)
    S = 16
    tok = fam.tokens(2, S + 3, jcfg.vocab_size, 3)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :S])}, cache_dtype=jnp.float32)
    cache = fam.port_cache(jc)
    for step in range(3):
        nxt = tok[:, S + step:S + step + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jnp.int32(S + step))
        tl, cache = tm.decode_step(torch.from_numpy(nxt), cache, None)   # pos is ignored
        fam.close(tl, jl)
        fam.close_cache(cache, jc)


def test_decode_equals_longer_prefill():
    jcfg, _, _, tm = fam.pair(ARCH)
    S = 15
    tok = torch.from_numpy(fam.tokens(2, S + 1, jcfg.vocab_size, 7))
    _, cache = tm.prefill({"tokens": tok[:, :S]}, cache_dtype=torch.float32)
    got, _ = tm.decode_step(tok[:, S:], cache)
    fam.close(got, tm.prefill({"tokens": tok}, cache_dtype=torch.float32)[0])
    fam.close(got, tm.logits(tm.hidden_states({"tokens": tok})[:, -1:]))
