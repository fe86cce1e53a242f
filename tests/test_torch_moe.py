"""The port's MoE layer and MoE decoder LMs against the JAX package, on the CPU.

The layer (``models/moe.py``) holds the reference's ``moe_init`` tree,
converted leaf by leaf, and both packages route the same numpy inputs: the
expert ids and the order of the gates are bit-equal to ``jax.lax.top_k``'s
(lower id first on ties), and so is the drop pattern, the (token, pick)
pairs past their expert's capacity, which the tests rebuild from the
reference's own ids with its own sort-based dispatch; outputs and the aux
loss agree within 1e-4 (float32).  The grouped dispatch equals the global one
without drops, and a tiny capacity drops most tokens, as
tests/test_models_core.py holds the reference.  The two MoE architectures'
reduced configs (qwen2-moe, and llama4 with patch embeddings) match the
reference's hidden states, aux loss, prefill logits, every cache entry and
decode steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.convert import _leaves
from repro_torch.models import DecoderLM, moe

RNG = np.random.default_rng(7)


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    d_model: int = 32
    n_experts: int = 8
    top_k: int = 2
    d_ff: int = 64
    moe_d_ff: int = 64
    n_shared_experts: int = 1
    capacity_factor: float = 8.0   # no drops: grouped == global exactly
    renorm_topk: bool = True
    moe_dispatch_groups: int = 0


def _layer(cfg, seed=0):
    """(jax params, port MoEParams holding them)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    tp = moe.MoEParams(torch.Generator().manual_seed(0), cfg, device="cpu",
                       dtype=torch.float32)
    own = dict(tp.named_parameters())
    for name, value in _leaves(fam.tree_np(jp)):
        assert tuple(own[name].shape) == value.shape
        with torch.no_grad():
            own[name].copy_(torch.from_numpy(np.array(value)))
    assert sorted(own) == sorted(n for n, _ in _leaves(fam.tree_np(jp)))
    return jp, tp


def _x(*shape):
    x = RNG.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _jax_routing(jp, x, cfg):
    """The reference's routing and dispatch, step by step as
    ``repro/models/moe.py::_moe_dispatch`` takes them: (expert ids, gates,
    keep) in the reference's (token, pick) sorted order."""
    N = x.shape[0] * x.shape[1]
    xf = x.reshape(N, -1)
    probs = jax.nn.softmax((xf.astype(jnp.float32) @ jp["router"]).astype(jnp.float32), -1)
    gates, ids = jax.lax.top_k(probs, cfg.top_k)
    if cfg.renorm_topk and cfg.top_k > 1:
        gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    flat = ids.reshape(-1)
    sort_idx = jnp.argsort(flat, stable=True)
    counts = jnp.bincount(flat, length=cfg.n_experts)
    start = jnp.cumsum(counts) - counts
    keep = jnp.arange(N * cfg.top_k) - start[flat[sort_idx]] < jmoe.capacity(N, cfg)
    return np.asarray(ids), np.asarray(gates), np.asarray(sort_idx), np.asarray(keep)


@pytest.mark.parametrize("top_k,cf,shared", [(2, 8.0, 1), (1, 1.25, 1), (4, 1.0, 0),
                                             (1, 0.1, 0)])
def test_layer_matches_reference(top_k, cf, shared):
    cfg = MoeCfg(top_k=top_k, capacity_factor=cf, n_shared_experts=shared)
    jp, tp = _layer(cfg)
    jx, tx = _x(4, 16, cfg.d_model)
    jy, jaux = jmoe.moe_apply(jp, jx, cfg)
    ty, taux = moe.moe_apply(tp, tx, cfg)
    fam.close(ty, jy)
    fam.close(taux, jaux)
    # routing and the drop pattern: bit-equal
    ids, gates, sort_idx, keep = _jax_routing(jp, jx, cfg)
    _, tg, tids = moe.route(tp, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_allclose(tg.numpy(), gates, atol=1e-6)
    tsort, _, tkeep = moe.dispatch(tids, cfg.n_experts, moe.capacity(64, cfg))
    np.testing.assert_array_equal(tsort.numpy(), sort_idx)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if not shared:      # a token with every pick dropped gives exactly 0, in both
        np.testing.assert_array_equal(np.all(ty.numpy() == 0, -1),
                                      np.all(np.asarray(jy) == 0, -1))


def test_top_k_ties_go_to_the_lower_expert():
    cfg = MoeCfg(top_k=2)
    _, tp = _layer(cfg)
    with torch.no_grad():
        tp.router.zero_()           # every expert ties: 0 and 1 win, in order
    _, gates, ids = moe.route(tp, torch.ones(5, cfg.d_model), cfg)
    assert (ids == torch.tensor([0, 1])).all() and torch.allclose(gates, torch.full((5, 2), 0.5))
    _, jids = jax.lax.top_k(jnp.full((5, cfg.n_experts), 1.0 / cfg.n_experts), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_grouped_equals_global():
    cfg = MoeCfg()
    jp, tp = _layer(cfg)
    jx, tx = _x(4, 16, cfg.d_model)
    y1, _ = moe.moe_apply(tp, tx, cfg)
    cfg_g = dataclasses.replace(cfg, moe_dispatch_groups=4)
    y2, aux2 = moe.moe_apply(tp, tx, cfg_g)
    fam.close(y2, y1, 2e-5)
    jy2, jaux2 = jmoe.moe_apply(jp, jx, cfg_g)
    fam.close(y2, jy2)
    fam.close(aux2, jaux2)


def test_capacity_drops_tokens():
    cfg = dataclasses.replace(MoeCfg(), capacity_factor=0.1, top_k=1, n_shared_experts=0)
    jp, tp = _layer(cfg)
    jx, tx = _x(2, 64, cfg.d_model)
    y, aux = moe.moe_apply(tp, tx, cfg)
    zero = np.all(y.numpy() == 0, axis=-1)
    assert zero.mean() > 0.3 and np.isfinite(float(aux))
    jy, _ = jmoe.moe_apply(jp, jx, cfg)
    np.testing.assert_array_equal(zero, np.all(np.asarray(jy) == 0, axis=-1))


def test_capacity_is_the_reference_rule():
    for n in (1, 7, 16, 100, 3070, 5118):
        for cfg in (MoeCfg(), MoeCfg(top_k=4, capacity_factor=1.25, n_experts=60),
                    MoeCfg(top_k=1, capacity_factor=1.25, n_experts=128)):
            assert moe.capacity(n, cfg) == jmoe.capacity(n, cfg)


# ------------------------------------------------------------------ models
ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
# the reduced configs (capacity factor 4: no drops) and qwen2-moe at its own
# factor, 1.25, where a 2 x 24 prefill drops 5 and 17 (token, pick) pairs in
# its two layers
CASES = {a: (a, ()) for a in ARCHS}
CASES["qwen2-moe-drops"] = ("qwen2-moe-a2.7b", (("capacity_factor", 1.25),))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hidden_states_and_aux(case):
    jcfg, jm, params, tm = fam.pair(*CASES[case])
    tok = fam.tokens(2, 24, jcfg.vocab_size, 1)
    jb, tb = fam.batches(jcfg, tok, seed=1)
    want, jaux = jm.hidden_states(params, jb)
    got, aux = tm.hidden_states(tb)
    fam.close(got, want)
    fam.close(aux, jaux)
    assert float(aux) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_and_cache(case):
    jcfg, jm, params, tm = fam.pair(*CASES[case])
    tok = fam.tokens(2, 24, jcfg.vocab_size, 2)
    jb, tb = fam.batches(jcfg, tok, seed=2)
    max_len = 24 + fam.n_front(jcfg) + 8
    jl, jc = jm.prefill(params, jb, max_len, cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tb, max_len, cache_dtype=torch.float32)
    fam.close(tl, jl)
    fam.close_cache(tc, jc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_after_prefill(case):
    jcfg, jm, params, tm = fam.pair(*CASES[case])
    S, nf = 20, fam.n_front(jcfg)
    tok = fam.tokens(2, S + 2, jcfg.vocab_size, 3)
    jb, _ = fam.batches(jcfg, tok[:, :S], seed=3)
    _, jc = jm.prefill(params, jb, S + nf + 8, cache_dtype=jnp.float32)
    cache = fam.port_cache(jc)
    for step in range(2):
        nxt = tok[:, S + step:S + step + 1]
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc, jnp.int32(S + nf + step))
        tl, cache = tm.decode_step(torch.from_numpy(nxt), cache, S + nf + step)
        fam.close(tl, jl)
        fam.close_cache(cache, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_longer_prefill(arch):
    jcfg, _, _, tm = fam.pair(arch)
    S, nf = 20, fam.n_front(jcfg)
    tok = fam.tokens(2, S + 1, jcfg.vocab_size, 7)
    _, prompt = fam.batches(jcfg, tok[:, :S], seed=7)
    _, full = fam.batches(jcfg, tok, seed=7)
    _, cache = tm.prefill(prompt, S + nf + 8, cache_dtype=torch.float32)
    got, _ = tm.decode_step(full["tokens"][:, S:], cache, S + nf)
    hidden, _ = tm.hidden_states(full)
    fam.close(got, tm.logits(hidden[:, -1:]))


def test_router_stays_fp32_in_bf16():
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(), dtype="bfloat16")
    model = DecoderLM(cfg, "cpu")
    blk = model.layers[0].moe
    assert blk.router.dtype == torch.float32 and blk.wi.dtype == torch.bfloat16
    x = torch.randn(2, 8, cfg.d_model).to(torch.bfloat16)
    y, aux = moe.moe_apply(blk, x, cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
