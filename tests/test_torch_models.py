"""The port's dense DecoderLM and serving executor against the JAX package.

Both packages run ``get_arch("qwen3-1.7b").reduced()`` (float32, 2 layers,
d=64, 4 heads, 2 kv heads, head_dim 16) and a reduced gemma2 with the same
weights: the JAX ``DecoderLM.init(PRNGKey(0))`` tree, converted by
``convert.model_from_jax``.  On the CPU the port's attention runs
``ops.flash_attention``/``ops.decode_attention``, whose plain versions take
the arguments the card's kernels take, so hidden states, logits and every
KV-cache entry agree within 1e-4 (float32 sums in another order).  Argmax tokens must be
equal except where the reference's top two logits lie within 1e-4.

Every architecture of the registry builds in the port, and its converter
round-trips the JAX tree; prefill then decode equals the longer forward for
all 10 (as tests/test_models_smoke.py holds the reference).  The executor
prefills an MoE model's requests one at a time, as the reference does: a
batched prefill would drop other tokens (capacity couples the rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import _family_leaves, cache_from_jax, model_from_jax
from repro_torch.core.lsh import LSHParams, normalize
from repro_torch.launch.serve import make_executor, make_request, rows_coupled
from repro_torch.models import DecoderLM, build_model, model_class
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
        out[case] = (jcfg, jm, params, model_from_jax(tcfg, _tree_np(params), "cpu"))
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


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_family_builds_and_converts(name):
    """``build_model`` gives the reference's class for the family, and the
    converter puts the JAX tree's values on the parameters: the same
    number of values, the same multiset of them, each leaf row on the
    parameter it names."""
    cfg = get_arch(name).reduced()
    model = build_model(cfg, "cpu")
    jm = j_build_model(j_get_arch(name).reduced())
    assert type(model) is model_class(cfg) and type(model).__name__ == type(jm).__name__
    params = fam.tree_np(jm.init(jax.random.PRNGKey(1)))
    own = dict(model_from_jax(cfg, params, "cpu").named_parameters())
    leaves = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(params)]
    assert sum(p.numel() for p in own.values()) == sum(x.size for x in leaves)
    np.testing.assert_array_equal(
        np.sort(np.concatenate([p.detach().float().numpy().ravel() for p in own.values()])),
        np.sort(np.concatenate([x.ravel() for x in leaves])))
    for leaf, value in _family_leaves(model, params):
        np.testing.assert_array_equal(own[leaf].detach().float().numpy(), value)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_consistency(arch):
    """Prefill(prompt) then decode(token) equals the longer forward's last
    logits, the vision families with patches (decode at S + patches); the
    hybrid, xLSTM and encoder-decoder families through the replay of a
    longer prefill (tests/test_models_smoke.py)."""
    jcfg, _, _, tm = fam.pair(arch)
    B, S = 2, 16
    tok = fam.tokens(B, S + 1, jcfg.vocab_size, 7)
    _, prompt = fam.batches(jcfg, tok[:, :S], seed=7)
    _, full = fam.batches(jcfg, tok, seed=7)
    nf = fam.n_front(jcfg)
    logits_p, cache = tm.prefill(prompt, S + nf + 8, cache_dtype=torch.float32)
    assert torch.isfinite(logits_p).all()
    got, _ = tm.decode_step(full["tokens"][:, S:], cache, S + nf)
    assert got.shape == (B, 1, jcfg.vocab_size) and torch.isfinite(got).all()
    if jcfg.is_encdec or jcfg.family in ("hybrid", "ssm"):
        want, _ = tm.prefill(full, S + 8, cache_dtype=torch.float32)
    else:
        hidden, _ = tm.hidden_states(full)
        want = tm.logits(hidden[:, -1:])
    _close(got, want)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m", "seamless-m4t-large-v2"])
def test_stateful_decode_matches_replay(arch):
    """Recurrent and encoder-decoder families: decode after prefill equals
    the reference's longer prefill, and so does the port's."""
    jcfg, jm, params, tm = fam.pair(arch)
    B, S = 2, 12
    tok = fam.tokens(B, S + 1, jcfg.vocab_size, 3)
    jb, tb = fam.batches(jcfg, tok[:, :S], seed=3)
    jfull, tfull = fam.batches(jcfg, tok, seed=3)
    _, cache = tm.prefill(tb, S + 4, cache_dtype=torch.float32)
    got, _ = tm.decode_step(tfull["tokens"][:, S:], cache, S)
    want, _ = jm.prefill(params, jfull, S + 4, cache_dtype=jnp.float32)
    _close(got, want)
    _close(got, tm.prefill(tfull, S + 4, cache_dtype=torch.float32)[0])


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


# the reduced qwen2-moe at qwen2-moe's own capacity factor (1.25; the
# reduced config's 4.0 drops nothing): a batched prefill of these 12 prompts
# drops other tokens than 12 prefills at batch 1, and changes argmax tokens
MOE_EXEC = ("qwen2-moe-a2.7b", (("capacity_factor", 1.25),))


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_executor_matches_reference_loop(pair, case):
    """The dense model's miss group runs as one (12, 16) prefill; the MoE
    model's requests run one at a time (rows_coupled), where one batched
    prefill would give other tokens."""
    jcfg, jm, params, tm = pair["dense"] if case == "dense" else fam.pair(*MOE_EXEC)
    assert rows_coupled(tm.cfg) == (case == "moe")
    embs = normalize(np.random.default_rng(5).standard_normal((12, 64)).astype(np.float32))
    reqs = [make_request(i, "svc", e, SEQ_LEN, jcfg.vocab_size) for i, e in enumerate(embs)]
    for r, e in zip(reqs, embs):
        want = (np.abs(e[:SEQ_LEN]) * 1e4).astype(np.int64) % jcfg.vocab_size
        assert r.payload["tokens"].shape == (1, SEQ_LEN)
        assert (r.payload["tokens"][0].numpy() == want).all()
    want = _reference_tokens(jcfg, jm, params, embs)
    _check_tokens(make_executor(tm, SEQ_LEN)(reqs), *want)
    assert make_executor(tm, SEQ_LEN)([]) == []
    if case == "moe":
        batched, _ = tm.prefill({"tokens": torch.cat([r.payload["tokens"] for r in reqs])},
                                SEQ_LEN + 8)
        assert (batched[:, -1].argmax(-1).numpy() != want[0]).any()


def test_executor_needs_frames_for_encdec():
    """The encoder-decoder model has no frames in a request's payload: the
    executor fails as the reference's does (no invented frames)."""
    jcfg, jm, params, tm = fam.pair("seamless-m4t-large-v2")
    req = make_request(0, "svc", np.ones(64, np.float32), SEQ_LEN, jcfg.vocab_size)
    with pytest.raises(KeyError, match="frames"):
        make_executor(tm, SEQ_LEN)([req])
    with pytest.raises(KeyError, match="frames"):
        jm.prefill(params, {"tokens": jnp.asarray(req.payload["tokens"].numpy())}, SEQ_LEN + 8)


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
