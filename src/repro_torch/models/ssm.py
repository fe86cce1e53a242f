"""Mamba2 (SSD) blocks for the hybrid zamba2-7b architecture.

Port of ``repro/models/ssm.py``: the state-space-duality form of Mamba2,
scalar-per-head decay ``dA = dt * A`` with matrix state ``h_t (heads,
head_dim, d_state)``:

  h_t = exp(dA_t) * h_{t-1} + dt_t * B_t x_t^T      (recurrent/decode form)
  y_t = C_t . h_t + D * x_t

Prefill uses the chunked algorithm (intra-chunk quadratic form + an
inter-chunk state recurrence, a loop over chunks); decode is one state
update.  A depthwise causal conv (width 4) precedes x/B/C; n_groups = 1.
The scan is plain PyTorch in fp32, as the reference leaves it plain jnp.

Parameters are a dict of tensors with the reference's names: ``in_proj``,
``out_proj`` and ``conv_w`` in the activation dtype for serving, fp32
masters in the training construction, each cast to the activations' dtype
at use (as the reference casts its fp32 masters); the rest fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, rms_norm

CONV_WIDTH = 4


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state  # x + B + C (n_groups=1)


def ssm_dims(cfg) -> SSMDims:
    d_inner = 2 * cfg.d_model
    head_dim = getattr(cfg, "ssm_head_dim", 64)
    return SSMDims(cfg.d_model, d_inner, d_inner // head_dim, head_dim, cfg.ssm_state)


def mamba2_init(gen: torch.Generator, cfg, *, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    d = ssm_dims(cfg)
    in_dim = 2 * d.d_inner + 2 * d.d_state + d.n_heads  # z, x, B, C, dt
    f32 = {"device": device, "dtype": torch.float32}
    conv_w = torch.randn((CONV_WIDTH, d.conv_dim), generator=gen, **f32).mul_(0.1)
    return {
        "in_proj": dense_init(gen, d.d_model, in_dim, device=device, dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d.conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, d.n_heads, **f32)),
        "dt_bias": torch.zeros((d.n_heads,), **f32),
        "D": torch.ones((d.n_heads,), **f32),
        "norm": torch.zeros((d.d_inner,), **f32),
        "out_proj": dense_init(gen, d.d_inner, d.d_model, device=device, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq: x (B, L, C), w (W, C)."""
    W, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(W))
    return F.silu(out + b.to(out.dtype))


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The causal conv at the last of the W rows of ``hist`` (B, W, C): one
    decode step of ``_causal_conv``."""
    conv = sum(hist[:, i, :] * w[i] for i in range(CONV_WIDTH))
    return F.silu(conv + b.to(conv.dtype))


def _split_in(params, x: torch.Tensor, d: SSMDims):
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(proj, [d.d_inner, d.conv_dim, d.n_heads], dim=-1)
    return z, xbc, dt


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): S[q, k] = sum_{j=k+1..q} x_j, -inf above the
    diagonal (exp of it is exactly 0)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def chunk_len(L: int, chunk: int) -> Tuple[int, int]:
    """(chunks, length of each) as the reference cuts L: ``max(1, L //
    chunk)`` chunks of ``L // chunks``; raises unless they tile L."""
    nchunk = max(1, L // chunk)
    Q = L // nchunk
    if Q * nchunk != L:
        raise ValueError(f"seq {L} not divisible by chunk {Q}")
    return nchunk, Q


def mamba2_apply(params, x_in: torch.Tensor, cfg, chunk: int = 256,
                 initial_state: Optional[torch.Tensor] = None, return_state: bool = False):
    """Chunked SSD forward: x_in (B, L, d_model) -> (B, L, d_model) [and the
    final state (B, H, P, N) fp32]."""
    d = ssm_dims(cfg)
    B_, L, _ = x_in.shape
    z, xbc, dt_raw = _split_in(params, x_in, d)
    xbc = _causal_conv(xbc, params["conv_w"].to(x_in.dtype), params["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc, [d.d_inner, d.d_state, d.d_state], dim=-1)
    xh = xs.reshape(B_, L, d.n_heads, d.head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])     # (B, L, H)
    A = -torch.exp(params["A_log"])                           # (H,) negative
    dA = dt * A

    nchunk, Q = chunk_len(L, chunk)

    def r(t, *shape):
        return t.reshape(B_, nchunk, Q, *shape)

    xc = r(xh, d.n_heads, d.head_dim).float()
    dtc = r(dt, d.n_heads)
    dAc = r(dA, d.n_heads)                       # (B, C, Q, H)
    Bc = r(Bmat, d.d_state).float()              # (B, C, Q, N)
    Cc = r(Cmat, d.d_state).float()

    dAc_h = dAc.movedim(-1, -2)                  # (B, C, H, Q)
    cum = torch.cumsum(dAc_h, dim=-1)

    # intra-chunk (quadratic within a chunk)
    Ldecay = torch.exp(_segsum(dAc_h))           # (B, C, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    gated = scores[:, :, None] * Ldecay
    xdt = xc * dtc[..., None]                    # (B, C, Q, H, P)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gated, xdt)

    # chunk states
    decay_states = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bckn,bchk,bckhp->bchpn", Bc, decay_states, xdt)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])        # (B, C, H)
    h = (torch.zeros((B_, d.n_heads, d.head_dim, d.d_state), device=x_in.device)
         if initial_state is None else initial_state.float())
    h_in = []
    for c in range(nchunk):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)              # (B, C, H, P, N)

    out_decay = torch.exp(cum)
    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cc, h_in, out_decay)

    y = (y_diag + y_off).reshape(B_, L, d.n_heads, d.head_dim)
    y = y + xc.reshape(B_, L, d.n_heads, d.head_dim) * params["D"][:, None]
    y = y.reshape(B_, L, d.d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], getattr(cfg, "norm_eps", 1e-6))
    out = y @ params["out_proj"].to(x_in.dtype)
    if return_state:
        return out, h
    return out


def mamba2_decode(params, x_in: torch.Tensor, cfg, state: torch.Tensor,
                  conv_buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. state: (B, H, P, N) f32; conv_buf: (B, W-1,
    conv_dim).  Returns (out (B, 1, d_model), new state, new buffer)."""
    d = ssm_dims(cfg)
    B_ = x_in.shape[0]
    z, xbc, dt_raw = _split_in(params, x_in[:, 0, :], d)
    hist = torch.cat([conv_buf.to(x_in.dtype), xbc[:, None, :]], dim=1)
    xbc_c = _conv_step(hist, params["conv_w"].to(x_in.dtype), params["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc_c, [d.d_inner, d.d_state, d.d_state], dim=-1)
    xh = xs.reshape(B_, d.n_heads, d.head_dim).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])     # (B, H)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bmat.float())
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cmat.float(), state) + xh * params["D"][:, None]
    y = y.reshape(B_, d.d_inner).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], getattr(cfg, "norm_eps", 1e-6))
    out = (y @ params["out_proj"].to(x_in.dtype))[:, None, :]
    return out, state, hist[:, 1:, :]


def mamba2_state_shapes(cfg, batch: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    d = ssm_dims(cfg)
    return (batch, d.n_heads, d.head_dim, d.d_state), (batch, CONV_WIDTH - 1, d.conv_dim)
