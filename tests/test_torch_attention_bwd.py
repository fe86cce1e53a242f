"""K6's gradient in the port against the JAX package, on the CPU.

The reference has no Pallas backward: it takes ``jax.grad`` of the same
attention math.  The port's plain backward ``ref.flash_attention_bwd_ref``
(explicit formulas, the backward kernel's arithmetic) and the forward's
log-sum-exp are held against ``jax.grad`` of the reference's
``repro.kernels.ref.flash_attention_ref`` and ``attn_core``, and against
torch autograd of the port's plain forward, within 1e-5 of each tensor's
largest magnitude at float32.  A row that sees no key gives zero gradients
(the reference's oracles give such a row the mean of V, so it is held
against the port's plain forward only).  On the CPU the wrapper's autograd
Function runs the plain forward and backward on the arguments the card's
kernels take; without grad the call is the plain forward, as before.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import attn_core as j_attn_core
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref

TOL = 1e-5

# (B, S, T, H, KV, D, kwargs): causal GQA, window, softcap, both, MHA
# without a causal mask and S != T, MQA with a scale
CASES = {
    "causal_gqa": (2, 40, 40, 8, 2, 16, {}),
    "window": (1, 37, 37, 4, 2, 32, {"window": 7}),
    "softcap": (2, 24, 24, 4, 4, 16, {"softcap": 1.5}),
    "window_softcap": (1, 33, 33, 8, 4, 16, {"window": 5, "softcap": 2.0}),
    "cross": (2, 19, 45, 4, 4, 32, {"causal": False}),
    "mqa_scale": (1, 30, 30, 4, 1, 64, {"scale": 0.3}),
}


def _inputs(B, S, T, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D)))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _port_bwd(q, k, v, do, kw):
    """The plain forward with lse, then the plain backward, on numpy inputs."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    return out, lse, ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)


def _jax_grads(fn, q, k, v, do):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v) * do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_grad_of_the_reference(case):
    B, S, T, H, KV, D, kw = CASES[case]
    q, k, v, do = _inputs(B, S, T, H, KV, D)
    _, _, grads = _port_bwd(q, k, v, do, kw)
    want = _jax_grads(lambda q, k, v: jref.flash_attention_ref(q, k, v, **kw), q, k, v, do)
    for got, w in zip(grads, want):
        _close(got, w)


class _Cfg:
    def __init__(self, softcap=None, scalar=None):
        self.attn_logit_softcap = softcap
        self.query_pre_attn_scalar = scalar


@pytest.mark.parametrize("case", ["causal_gqa", "window", "window_softcap"])
def test_backward_matches_jax_grad_of_attn_core(case):
    """The model's attention math (``attn_core``: the path the reference's
    ``DecoderLM.loss`` differentiates), at float32."""
    B, S, T, H, KV, D, kw = CASES[case]
    q, k, v, do = _inputs(B, S, T, H, KV, D, seed=1)
    cfg = _Cfg(kw.get("softcap"))
    _, _, grads = _port_bwd(q, k, v, do, kw)
    want = _jax_grads(lambda q, k, v: j_attn_core(q, k, v, cfg=cfg, window=kw.get("window")),
                      q, k, v, do)
    for got, w in zip(grads, want):
        _close(got, w)


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_the_reference_logsumexp(case):
    B, S, T, H, KV, D, kw = CASES[case]
    q, k, v, _ = _inputs(B, S, T, H, KV, D, seed=2)
    _, lse, _ = _port_bwd(q, k, v, np.zeros_like(q), kw)
    G, scale = H // KV, kw.get("scale", 1.0 / np.sqrt(D))
    logits = jnp.einsum("bskgd,btkd->bkgst", q.reshape(B, S, KV, G, D), k) * scale
    if kw.get("softcap") is not None:
        logits = kw["softcap"] * jnp.tanh(logits / kw["softcap"])
    s, t = np.arange(S)[:, None], np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if kw.get("causal", True):
        mask &= t <= s
    if kw.get("window") is not None:
        mask &= t > s - kw["window"]
    want = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1).reshape(B, H, S)
    _close(lse, want)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_torch_autograd_of_the_plain_forward(case):
    B, S, T, H, KV, D, kw = CASES[case]
    q, k, v, do = _inputs(B, S, T, H, KV, D, seed=3)
    _, _, grads = _port_bwd(q, k, v, do, kw)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ref.flash_attention_ref(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for got, w in zip(grads, want):
        _close(got, w)


def test_rows_without_a_key_get_zero_gradients():
    """Causal with a window of 8 over T=16 keys: positions 23.. see none.
    Their lse is +inf, their dq is 0, and no gradient is NaN."""
    B, S, T, H, KV, D, kw = 1, 48, 16, 4, 2, 32, {"window": 8}
    q, k, v, do = _inputs(B, S, T, H, KV, D, seed=4)
    out, lse, (dq, dk, dv) = _port_bwd(q, k, v, do, kw)
    assert torch.isinf(lse[..., 23:]).all() and (lse[..., 23:] > 0).all()
    assert torch.isfinite(lse[..., :23]).all()
    assert (dq[:, 23:] == 0).all() and (out[:, 23:] == 0).all()
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(tq, tk, tv, **kw), (tq, tk, tv),
                               torch.from_numpy(do))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w)


@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap", "cross"])
def test_autograd_function_on_the_cpu_is_the_plain_path(case):
    """``ops.flash_attention`` with inputs that require grad goes through
    ``FlashAttention``: the same output as the plain forward and the same
    gradients as torch autograd through it."""
    B, S, T, H, KV, D, kw = CASES[case]
    q, k, v, do = _inputs(B, S, T, H, KV, D, seed=5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    plain = ref.flash_attention_ref(pq, pk, pv, **kw)
    _close(out, plain, tol=0)
    want = torch.autograd.grad(plain, (pq, pk, pv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w)


def test_call_without_grad_is_the_plain_route():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 20, 20, 4, 2, 16, seed=6))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    with torch.no_grad():
        rq = q.clone().requires_grad_()
        out = ops.flash_attention(rq, k, v)
    assert out.grad_fn is None and torch.equal(out, ref.flash_attention_ref(q, k, v))


def test_bf16_backward_is_the_f32_math_rounded():
    """bf16 inputs: the gradients are the fp32 formulas on the bf16 values,
    rounded once to bf16 (within one bf16 ulp of the f32 result)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(2, 40, 40, 8, 2, 16, seed=7))
    out, lse = fk.forward(q, k, v, True, None, None, 0.25, with_lse=True)
    got = fk.backward(q, k, v, out, lse, do, True, None, None, 0.25)
    want = ref.flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out)), lse, do.float(),
                                       scale=0.25)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2.0 ** -8, atol=1e-6)
