"""The port's dense DecoderLM and serving executor against the JAX package.

Both packages run ``get_arch("qwen3-1.7b").reduced()`` (float32, 2 layers,
d=64, 4 heads, 2 kv heads, head_dim 16) and a reduced gemma2 with the same
weights: the JAX ``DecoderLM.init(PRNGKey(0))`` tree, converted by
``convert.decoder_lm_from_jax``.  On the CPU the port's attention runs
``ops.flash_attention``/``ops.decode_attention``, whose plain versions take
the arguments the card's kernels take, so hidden states, logits and every
KV-cache entry agree within 1e-4 (float32 sums in another order).  Argmax tokens must be
equal except where the reference's top two logits lie within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import cache_from_jax, decoder_lm_from_jax
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.launch.serve import make_executor, make_request
from repro_torch.models import DecoderLM, build_model
from repro_torch.serving.engine import ReplicaEngine

TOL = 1e-4
ARGMAX_MARGIN = 1e-4

# case -> (arch, changes to its reduced config).  The reduced qwen3; a ring
# variant: local (window 16) and global layers alternating over two groups,
# so W < S, W == S and W > S all occur; and the reduced gemma2, which routes
# a logit softcap, a window of 32 and query_pre_attn_scalar through the
# attention ops (its cap lowered to 1 so that it bends these small logits).
CASES = {
    "dense": ("qwen3-1.7b", {}),
    "ring": ("qwen3-1.7b", {"sliding_window": 16, "layer_pattern": ("local", "global"),
                            "n_layers": 4}),
    "gemma2": ("gemma2-9b", {"attn_logit_softcap": 1.0}),
}


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """case -> (jax cfg, jax model, jax params, port model)."""
    out = {}
    for case, (arch, change) in CASES.items():
        jcfg = dataclasses.replace(j_get_arch(arch).reduced(), **change)
        tcfg = dataclasses.replace(get_arch(arch).reduced(), **change)
        jm = JDecoderLM(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        out[case] = (jcfg, jm, params, decoder_lm_from_jax(tcfg, _tree_np(params), "cpu"))
    return out


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# -------------------------------------------------------------------- configs
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_configs_are_the_reference_configs(name):
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for t, j in ((ARCHS[name], J_ARCHS[name]), (ARCHS[name].reduced(), J_ARCHS[name].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.flops_params() == j.flops_params()


# ---------------------------------------------------------------------- model
@pytest.mark.parametrize("case", sorted(CASES))
def test_hidden_states(pair, case):
    jcfg, jm, params, tm = pair[case]
    tok = _tokens(2, 24, jcfg.vocab_size, 1)
    want, _ = jm.hidden_states(params, {"tokens": jnp.asarray(tok)})
    got, aux = tm.hidden_states({"tokens": torch.from_numpy(tok)})
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("case,S,extra", [("dense", 24, 0), ("dense", 24, 8),
                                          ("ring", 24, 8), ("ring", 40, 4),
                                          ("gemma2", 24, 8), ("gemma2", 40, 4)])
def test_prefill_logits_and_cache(pair, case, S, extra):
    """W == S (extra 0), W > S (padded), and W < S (the ring roll)."""
    jcfg, jm, params, tm = pair[case]
    tok = _tokens(2, S, jcfg.vocab_size, 2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tok)}, S + extra,
                        cache_dtype=jnp.float32)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tok)}, S + extra,
                        cache_dtype=torch.float32)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape and tc[name].dtype == torch.float32
        _close(tc[name], jc[name])


@pytest.mark.parametrize("case,S", [("dense", 24), ("ring", 24), ("ring", 40),
                                    ("gemma2", 40)])
def test_decode_step_after_prefill(pair, case, S):
    jcfg, jm, params, tm = pair[case]
    tok = _tokens(2, S + 2, jcfg.vocab_size, 3)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(tok[:, :S])}, S + 8,
                        cache_dtype=jnp.float32)
    cache = cache_from_jax(_tree_np(jc), "cpu")   # start from the reference's cache
    for step in range(2):
        nxt = tok[:, S + step:S + step + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jnp.int32(S + step))
        tl, cache = tm.decode_step(torch.from_numpy(nxt), cache, S + step)
        _close(tl, jl)
        for name in jc:
            _close(cache[name], jc[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_longer_prefill(pair, case):
    """prefill(prompt) then decode(token) == the full forward's last logits
    (as tests/test_models_smoke.py holds the reference)."""
    jcfg, _, _, tm = pair[case]
    B, S = 2, 20
    tok = torch.from_numpy(_tokens(B, S + 1, jcfg.vocab_size, 7))
    _, cache = tm.prefill({"tokens": tok[:, :S]}, S + 8, cache_dtype=torch.float32)
    got, _ = tm.decode_step(tok[:, S:], cache, S)
    hidden, _ = tm.hidden_states({"tokens": tok})
    _close(got, tm.logits(hidden[:, -1:]))


def test_cache_bf16_and_init_cache_layout(pair):
    jcfg, jm, params, tm = pair["ring"]
    tok = _tokens(1, 24, jcfg.vocab_size, 4)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(tok)}, 32)      # bf16 cache
    _, tc = tm.prefill({"tokens": torch.from_numpy(tok)}, 32)
    conv = cache_from_jax(_tree_np(jc), "cpu")
    for name in jc:
        assert conv[name].dtype == tc[name].dtype == torch.bfloat16
        _close(tc[name], conv[name], 2e-2)
    empty = tm.init_cache(3, 32)
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: v.shape for k, v in jm.init_cache(3, 32).items()}


def test_seeded_init_distributions():
    cfg = get_arch("qwen3-1.7b").reduced()
    a, b = DecoderLM(cfg, "cpu", seed=3), DecoderLM(cfg, "cpu", seed=3)
    c = DecoderLM(cfg, "cpu", seed=4)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed"], pc["embed"])
    assert abs(pa["embed"].std().item() - 0.02) < 2e-3
    wi = pa["layers.0.mlp.wi"]
    assert abs(wi.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert all(not p.requires_grad for p in pa.values())
    assert (pa["layers.1.attn.q_norm"] == 0).all() and pa["final_norm"].dtype == torch.float32


def test_other_families_raise():
    for name, cfg in ARCHS.items():
        red = cfg.reduced()
        if red.family == "dense" and not red.is_encdec:
            assert isinstance(build_model(red, "cpu"), DecoderLM)
            continue
        with pytest.raises(NotImplementedError, match="slice"):
            build_model(red, "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        DecoderLM(get_arch("qwen2-moe-a2.7b").reduced(), "cpu")


# ------------------------------------------------------------------- executor
SEQ_LEN = 16


def _reference_tokens(jcfg, jm, params, embs):
    """serve.py's executor, as the reference runs it: one prefill at batch 1
    per request, max_len = seq_len + 8, argmax of the last logits; with the
    top-two margin of each."""
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, SEQ_LEN + 8)[0])
    toks, margins = [], []
    for emb in embs:
        t = jnp.asarray((np.abs(emb[:SEQ_LEN]) * 1e4).astype(np.int64) % jcfg.vocab_size,
                        jnp.int32)[None, :]
        lg = np.asarray(prefill(params, {"tokens": t}))[0, -1]
        top = np.sort(lg)[-2:]
        toks.append(int(np.argmax(lg)))
        margins.append(float(top[1] - top[0]))
    return np.array(toks), np.array(margins)


def _check_tokens(got, want, margins):
    bad = (np.asarray(got) != want) & (margins >= ARGMAX_MARGIN)
    assert not bad.any(), (np.flatnonzero(bad), np.asarray(got)[bad], want[bad])


def test_executor_matches_reference_loop(pair):
    jcfg, jm, params, tm = pair["dense"]
    embs = normalize(np.random.default_rng(5).standard_normal((12, 64)).astype(np.float32))
    reqs = [make_request(i, "svc", e, SEQ_LEN, jcfg.vocab_size) for i, e in enumerate(embs)]
    for r, e in zip(reqs, embs):
        want = (np.abs(e[:SEQ_LEN]) * 1e4).astype(np.int64) % jcfg.vocab_size
        assert r.payload["tokens"].shape == (1, SEQ_LEN)
        assert (r.payload["tokens"][0].numpy() == want).all()
    got = make_executor(tm, SEQ_LEN)(reqs)                # one (12, 16) prefill
    _check_tokens(got, *_reference_tokens(jcfg, jm, params, embs))
    assert make_executor(tm, SEQ_LEN)([]) == []


def test_replica_serves_mixed_batches_with_the_model(pair):
    """Misses run the model (the reference's tokens); near-duplicates of
    executed requests are reused with their source's token."""
    jcfg, jm, params, tm = pair["dense"]
    rng = np.random.default_rng(6)
    execute = make_executor(tm, SEQ_LEN)
    calls = []
    eng = ReplicaEngine(0, LSHParams(dim=64, num_tables=5, num_probes=8),
                        lambda reqs: calls.append(len(reqs)) or execute(reqs), device="cpu")
    first = normalize(rng.standard_normal((16, 64)).astype(np.float32))
    res = eng.handle_batch([make_request(i, "svc", e, SEQ_LEN, jcfg.vocab_size)
                            for i, e in enumerate(first)])
    assert all(r.reuse is None for r in res)
    source_tok = {r.request_id: r.result for r in res}
    _check_tokens([r.result for r in res], *_reference_tokens(jcfg, jm, params, first))
    n_id = len(first)
    for _ in range(2):
        src = rng.integers(0, len(first), 8)
        near = normalize(first[src] + 0.01 * rng.standard_normal((8, 64)).astype(np.float32))
        fresh = normalize(rng.standard_normal((8, 64)).astype(np.float32))
        embs = np.concatenate([near, fresh])
        res = eng.handle_batch([make_request(n_id + i, "svc", e, SEQ_LEN, jcfg.vocab_size)
                                for i, e in enumerate(embs)])
        n_id += len(embs)
        for j, r in enumerate(res[:8]):
            assert r.reuse is not None and r.result == source_tok[int(src[j])]
        assert all(r.reuse is None for r in res[8:])
        _check_tokens([r.result for r in res[8:]], *_reference_tokens(jcfg, jm, params, fresh))
    assert calls == [16, 8, 8]
