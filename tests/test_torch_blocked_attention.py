"""``repro_torch.models.blocked_attention`` (K6 with ``q_offset``) against the
reference's ``blocked_attention``, the pure-XLA flash attention, on the
CPU (where K6 runs its plain version, ``kernels/ref.py``).

Mirrors ``tests/test_models_core.py::TestBlockedAttention``: the four mask
cases at block_q=32, block_k=16 within 3e-5; the gradients dq, dk, dv
against ``jax.grad`` of the reference within 1e-4; chunks of a longer
prompt (``q_offset`` 16 and 48, T = q_offset + S) and ragged T; the model
switch ``attn_impl="blocked"`` on reduced gemma2 (the port's two routes
within rtol 1e-3 of each other, and of the reference).  The kernels' own
block ranges with ``q_offset`` are driven on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.blocked_attention import blocked_attention as j_blocked
from repro_torch.models.blocked_attention import blocked_attention
from torch_families import pair

RNG = np.random.default_rng(0)


def _qkv(B, S, T, H, KV, D):
    return tuple(RNG.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))


def _port(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("kwargs", [
    {"causal": True}, {"causal": False},
    {"causal": True, "window": 24},
    {"causal": True, "softcap": 50.0},
])
def test_matches_reference(kwargs):
    q, k, v = _qkv(2, 80, 80, 8, 4, 32)
    got = blocked_attention(*_port(q, k, v), block_q=32, block_k=16, **kwargs)
    want = j_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=16,
                     **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("S,T,q_offset,kwargs", [
    (32, 32, 0, {"causal": True}),
    (32, 48, 16, {"causal": True}),
    (32, 80, 48, {"causal": True, "window": 24}),
    (24, 60, 48, {"causal": True, "softcap": 30.0}),     # ragged: T < q_offset + S
    (32, 90, 48, {"causal": True}),                      # ragged: keys past the last row
    (16, 64, 40, {"causal": True, "window": 8}),         # the window ends before the offset
    (32, 50, 48, {"causal": True, "window": 24, "softcap": 30.0}),
    (40, 40, 0, {"causal": False}),
])
def test_gradients_match_jax_grad(S, T, q_offset, kwargs):
    """dq, dk, dv of sum(out * w) through the port's autograd (K6's
    backward) against ``jax.grad`` of the reference."""
    q, k, v = _qkv(1, S, T, 4, 2, 16)
    w = RNG.standard_normal((1, S, 4, 16)).astype(np.float32)
    tq, tk, tv = _port(q, k, v, grad=True)
    (blocked_attention(tq, tk, tv, block_q=16, block_k=8, q_offset=q_offset, **kwargs)
     * torch.from_numpy(w)).sum().backward()

    def f(q_, k_, v_):
        return (j_blocked(q_, k_, v_, block_q=16, block_k=8, q_offset=q_offset, **kwargs)
                * w).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w_ in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), atol=1e-4)


@pytest.mark.parametrize("q_offset", [16, 48])
@pytest.mark.parametrize("extra", [0, -7, 9])          # T = q_offset + S + extra
@pytest.mark.parametrize("kwargs", [{"causal": True}, {"causal": True, "window": 20},
                                    {"causal": False}])
def test_q_offset_matches_reference(q_offset, extra, kwargs):
    S = 40
    q, k, v = _qkv(2, S, q_offset + S + extra, 8, 2, 32)
    got = blocked_attention(*_port(q, k, v), block_q=32, block_k=16, q_offset=q_offset,
                            **kwargs)
    want = j_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=16,
                     q_offset=q_offset, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_chunks_equal_the_whole_prompt():
    """A prompt's chunks at their offsets, each against the keys so far,
    give the whole prompt's rows."""
    q, k, v = _port(*_qkv(2, 96, 96, 8, 4, 32))
    whole = blocked_attention(q, k, v)
    parts = [blocked_attention(q[:, lo:lo + 32], k[:, :lo + 32], v[:, :lo + 32], q_offset=lo)
             for lo in range(0, 96, 32)]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), whole.numpy(), atol=1e-6)


def test_model_level_impl_switch():
    """Reduced gemma2 (local and global layers, softcaps): the loss through
    ``attn_impl="blocked"`` against the port's default route and against the
    reference's blocked model, from the same weights."""
    change = (("attn_block_q", 16), ("attn_block_k", 16))
    jcfg, jm, params, tm = pair("gemma2-9b", change)
    _, jm_b, _, tm_b = pair("gemma2-9b", change + (("attn_impl", "blocked"),))
    tokens = RNG.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens)}
    with torch.no_grad():
        l1, _ = tm.loss(tb)
        l2, _ = tm_b.loss(tb)
    jl, _ = jm_b.loss(params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-3)
    np.testing.assert_allclose(float(l2), float(jl), rtol=1e-3)
