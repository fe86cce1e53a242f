"""xLSTM blocks (sLSTM + mLSTM) for the xlstm-125m architecture.

Port of ``repro/models/xlstm.py``.

mLSTM: matrix-memory LSTM with exponential gating (parallelisable):
    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t . C_t) / max(|q_t . n_t|, exp(-m_t))
Prefill uses the stabilised parallel (quadratic) form, or the chunked form
(``cfg.mlstm_impl == "chunked"``: quadratic within a chunk, the recurrent
(C, n, m) state across chunks); decode is one state update.

sLSTM: scalar-memory LSTM with exponential gating and block-diagonal (per
head) recurrent weights; strictly sequential, a loop over time.

The recurrences are plain PyTorch, as the reference leaves them plain jnp.
Activations are the reference's: ``jax.nn.gelu`` is the tanh approximation,
``log_sigmoid`` is ``F.logsigmoid``; the stabilisers start at -1e30 (mLSTM)
and -10 (sLSTM).  Parameters are dicts of tensors with the reference's
names: the projections and ``conv_w`` in the activation dtype for serving
(fp32 masters in the training construction), each cast to the activations'
dtype at use; the biases, norm scales and sLSTM's recurrent ``r`` fp32 (as
the reference reads them).  The sLSTM time loop builds a new state each
step (no in-place write), so autograd runs through it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init, rms_norm
from .ssm import CONV_WIDTH, _causal_conv, _conv_step, chunk_len


class XLSTMDims(NamedTuple):
    d_model: int
    n_heads: int
    d_inner: int   # mLSTM up-projection (2x)
    dk: int        # mLSTM per-head q/k/v dim
    dh: int        # sLSTM per-head hidden dim


def xlstm_dims(cfg) -> XLSTMDims:
    d_inner = 2 * cfg.d_model
    return XLSTMDims(cfg.d_model, cfg.n_heads, d_inner,
                     d_inner // cfg.n_heads, cfg.d_model // cfg.n_heads)


def _eps(cfg) -> float:
    return getattr(cfg, "norm_eps", 1e-6)


# ======================================================================= mLSTM
def mlstm_init(gen: torch.Generator, cfg, *, device=None,
               dtype: torch.dtype = torch.float32) -> dict:
    d = xlstm_dims(cfg)
    kw = {"device": device, "dtype": dtype}
    f32 = {"device": device, "dtype": torch.float32}
    conv_w = torch.randn((CONV_WIDTH, d.d_inner), generator=gen, **f32).mul_(0.1)
    return {
        "up": dense_init(gen, d.d_model, 2 * d.d_inner, **kw),     # x branch + z gate
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d.d_inner,), **f32),
        "wq": dense_init(gen, d.d_inner, d.d_inner, **kw),
        "wk": dense_init(gen, d.d_inner, d.d_inner, **kw),
        "wv": dense_init(gen, d.d_inner, d.d_inner, **kw),
        "w_if": dense_init(gen, d.d_inner, 2 * cfg.n_heads, scale=0.02, **kw),
        "b_if": torch.cat([torch.zeros((cfg.n_heads,), **f32),
                           torch.full((cfg.n_heads,), 3.0, **f32)]),
        "norm": torch.zeros((d.d_inner,), **f32),
        "down": dense_init(gen, d.d_inner, d.d_model, **kw),
    }


def _gates(params, xb: torch.Tensor):
    """(log input gate, log forget gate), fp32, from the x branch."""
    gif = (xb @ params["w_if"].to(xb.dtype)).float() + params["b_if"]
    logi, fraw = gif.chunk(2, dim=-1)
    return logi, F.logsigmoid(fraw)


def _mlstm_qkvif(params, x: torch.Tensor, d: XLSTMDims):
    xb, z = (x @ params["up"].to(x.dtype)).chunk(2, dim=-1)
    xc = _causal_conv(xb, params["conv_w"].to(x.dtype), params["conv_b"])
    B, L = x.shape[:2]
    q = (xc @ params["wq"].to(x.dtype)).reshape(B, L, d.n_heads, d.dk)
    k = (xc @ params["wk"].to(x.dtype)).reshape(B, L, d.n_heads, d.dk)
    v = (xb @ params["wv"].to(x.dtype)).reshape(B, L, d.n_heads, d.dk)
    logi, logf = _gates(params, xb)              # (B, L, H)
    return q, k, v, logi, logf, z


def mlstm_parallel(q, k, v, logi, logf) -> torch.Tensor:
    """Stabilised parallel form. q, k, v: (B, L, H, D); gates (B, L, H)."""
    B, L, H, D = q.shape
    qf = q.float() / math.sqrt(D)
    kf, vf = k.float(), v.float()
    lf, li = logf.movedim(-1, 1), logi.movedim(-1, 1)          # (B, H, L)
    cum = torch.cumsum(lf, dim=-1)
    dt = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    dt = dt.masked_fill(~mask, -math.inf)
    m = dt.amax(dim=-1)                                          # (B, H, L)
    scores = torch.einsum("blhd,bshd->bhls", qf, kf) * torch.exp(dt - m[..., None])
    denom = torch.maximum(scores.sum(dim=-1).abs(), torch.exp(-m))
    h = torch.einsum("bhls,bshd->blhd", scores / denom[..., None], vf)
    return h.to(q.dtype)


def mlstm_chunked(q, k, v, logi, logf, chunk: int = 256, initial_state=None,
                  return_state: bool = False):
    """Chunked mLSTM: quadratic with local stabilisation within a chunk, the
    recurrent (C, n, m) state across chunks; equals ``mlstm_parallel``."""
    B, L, H, D = q.shape
    nc, Q = chunk_len(L, chunk)
    qf = q.float() / math.sqrt(D)
    kf, vf = k.float(), v.float()

    def r(t, *shape):
        return t.reshape(B, nc, Q, *shape)

    qc, kc, vc = r(qf, H, D), r(kf, H, D), r(vf, H, D)     # (B, nc, Q, H, D)
    lic = r(logi, H).movedim(-1, -2)                        # (B, nc, H, Q)
    lfc = r(logf, H).movedim(-1, -2)

    if initial_state is None:
        C_in = torch.zeros((B, H, D, D), device=q.device)
        n_in = torch.zeros((B, H, D), device=q.device)
        m_in = torch.full((B, H), -1e30, device=q.device)
    else:
        C_in, n_in, m_in = initial_state
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        qb, kb, vb, li, lf = qc[:, c], kc[:, c], vc[:, c], lic[:, c], lfc[:, c]
        cum = torch.cumsum(lf, dim=-1)                       # (B, H, Q) local decay
        w = (cum[..., :, None] - cum[..., None, :] + li[..., None, :]).masked_fill(
            ~mask, -math.inf)
        m_inter = m_in[..., None] + cum
        m_t = torch.maximum(w.amax(dim=-1), m_inter)
        scores = torch.einsum("bqhd,bshd->bhqs", qb, kb) * torch.exp(w - m_t[..., None])
        num = torch.einsum("bhqs,bshd->bqhd", scores, vb)
        inter_scale = torch.exp(m_inter - m_t)               # (B, H, Q)
        num_inter = torch.einsum("bqhd,bhde->bqhe", qb, C_in)
        num = num + num_inter * inter_scale.movedim(-1, 1)[..., None]
        b_inter = torch.einsum("bqhd,bhd->bhq", qb, n_in) * inter_scale
        den = torch.maximum((scores.sum(dim=-1) + b_inter).abs(), torch.exp(-m_t))
        hs.append(num / den.movedim(-1, 1)[..., None])      # (B, Q, H, D)
        # the state at the end of the chunk
        cum_end = cum[..., -1]
        w_out = cum_end[..., None] - cum + li
        m_out = torch.maximum(m_in + cum_end, w_out.amax(dim=-1))
        wo = torch.exp(w_out - m_out[..., None])
        decay = torch.exp(m_in + cum_end - m_out)
        C_in = C_in * decay[..., None, None] + torch.einsum("bhq,bqhd,bqhe->bhde", wo, kb, vb)
        n_in = n_in * decay[..., None] + torch.einsum("bhq,bqhd->bhd", wo, kb)
        m_in = m_out
    h = torch.stack(hs, dim=1).reshape(B, L, H, D).to(q.dtype)
    if return_state:
        return h, (C_in, n_in, m_in)
    return h


def mlstm_step(q, k, v, logi, logf, state):
    """O(1) recurrence. q, k, v: (B, H, D); gates (B, H); state (C, n, m)."""
    C, n, m = state
    qf = q.float() / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    m_new = torch.maximum(logf + m, logi)
    fp = torch.exp(logf + m - m_new)[..., None]
    ip = torch.exp(logi - m_new)[..., None]
    C = C * fp[..., None] + ip[..., None] * kf[..., :, None] * vf[..., None, :]
    n = n * fp + ip * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (C, n, m_new)


def _chunked(cfg) -> bool:
    return getattr(cfg, "mlstm_impl", "quadratic") == "chunked"


def _contract(x: torch.Tensor, w: torch.Tensor, split=None) -> torch.Tensor:
    """``x @ w`` of a product that contracts d_model; under ``split`` (a
    ``partitioning.EmbedSplit``: a decode step at batch 1) from this rank's
    rows of ``w``, the partial sums reduced over the batch axes."""
    return x @ w.to(x.dtype) if split is None else split.contract(x, w)


def _produce(h: torch.Tensor, w: torch.Tensor, split=None) -> torch.Tensor:
    """``h @ w`` of a product that makes d_model; under ``split`` only this
    rank's chunk of its columns."""
    return h @ w.to(h.dtype) if split is None else split.produce(h, w)


def _mlstm_out(params, h: torch.Tensor, z: torch.Tensor, cfg, d: XLSTMDims,
               split=None) -> torch.Tensor:
    h = rms_norm(h.reshape(*z.shape[:-1], d.d_inner), params["norm"], _eps(cfg))
    return _produce(h * F.silu(z), params["down"], split)


def mlstm_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    d = xlstm_dims(cfg)
    q, k, v, logi, logf, z = _mlstm_qkvif(params, x, d)
    if _chunked(cfg):
        h = mlstm_chunked(q, k, v, logi, logf, chunk=getattr(cfg, "scan_chunk", 256))
    else:
        h = mlstm_parallel(q, k, v, logi, logf)
    return _mlstm_out(params, h, z, cfg, d)


def mlstm_prefill(params, x: torch.Tensor, cfg):
    """Forward + the exact final recurrent state (C, n, m) + the conv
    buffer (the pre-conv x branch of the last W-1 positions, fp32)."""
    d = xlstm_dims(cfg)
    q, k, v, logi, logf, z = _mlstm_qkvif(params, x, d)
    if _chunked(cfg):
        h, (C, n, m_state) = mlstm_chunked(q, k, v, logi, logf,
                                           chunk=getattr(cfg, "scan_chunk", 256),
                                           return_state=True)
    else:
        h = mlstm_parallel(q, k, v, logi, logf)
        lf, li = logf.movedim(-1, 1), logi.movedim(-1, 1)   # (B, H, L)
        cum = torch.cumsum(lf, dim=-1)
        w_log = cum[..., -1:] - cum + li
        m_state = w_log.amax(dim=-1)
        w = torch.exp(w_log - m_state[..., None])
        kf, vf = k.float(), v.float()
        C = torch.einsum("bhl,blhd,blhe->bhde", w, kf, vf)
        n = torch.einsum("bhl,blhd->bhd", w, kf)
    out = _mlstm_out(params, h, z, cfg, d)
    up_tail = x[:, x.shape[1] - (CONV_WIDTH - 1):, :] @ params["up"].to(x.dtype)
    buf = up_tail.chunk(2, dim=-1)[0].float()
    return out, (C, n, m_state), buf


def mlstm_decode(params, x: torch.Tensor, cfg, state, conv_buf: torch.Tensor, split=None):
    """x: (B, 1, d_model); state (C (B, H, D, D), n (B, H, D), m (B, H)).
    Returns (out (B, 1, d_model), state, new conv buffer).  ``split``: the
    rank's part under ``embed_split`` (``_contract`` / ``_produce``): out is
    then its chunk of d_model; the 1536 x 1536 products stay whole."""
    d = xlstm_dims(cfg)
    B = x.shape[0]
    xb, z = _contract(x[:, 0, :], params["up"], split).chunk(2, dim=-1)
    hist = torch.cat([conv_buf.to(x.dtype), xb[:, None, :]], dim=1)
    xc = _conv_step(hist, params["conv_w"].to(x.dtype), params["conv_b"])
    q = (xc @ params["wq"].to(x.dtype)).reshape(B, d.n_heads, d.dk)
    k = (xc @ params["wk"].to(x.dtype)).reshape(B, d.n_heads, d.dk)
    v = (xb @ params["wv"].to(x.dtype)).reshape(B, d.n_heads, d.dk)
    logi, logf = _gates(params, xb)
    h, state = mlstm_step(q, k, v, logi, logf, state)
    return _mlstm_out(params, h, z, cfg, d, split)[:, None, :], state, hist[:, 1:, :]


def mlstm_state_shapes(cfg, batch: int):
    d = xlstm_dims(cfg)
    return (
        (batch, d.n_heads, d.dk, d.dk),      # C
        (batch, d.n_heads, d.dk),            # n
        (batch, d.n_heads),                  # m
        (batch, CONV_WIDTH - 1, d.d_inner),  # conv buffer
    )


# ======================================================================= sLSTM
def slstm_init(gen: torch.Generator, cfg, *, device=None,
               dtype: torch.dtype = torch.float32) -> dict:
    d = xlstm_dims(cfg)
    ffd = int(cfg.d_model * 4 / 3)
    kw = {"device": device, "dtype": dtype}
    f32 = {"device": device, "dtype": torch.float32}
    conv_w = torch.randn((CONV_WIDTH, d.d_model), generator=gen, **f32).mul_(0.1)
    wx = dense_init(gen, d.d_model, 4 * d.d_model, **kw)               # z, i, f, o
    r = torch.randn((d.n_heads, d.dh, 4 * d.dh), generator=gen, **f32).div_(math.sqrt(d.dh))
    return {
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d.d_model,), **f32),
        "wx": wx,
        "r": r,
        "b": torch.cat([torch.zeros((2 * d.d_model,), **f32),
                        torch.full((d.d_model,), 3.0, **f32),
                        torch.zeros((d.d_model,), **f32)]),
        "norm": torch.zeros((d.d_model,), **f32),
        "ff_wi": dense_init(gen, d.d_model, 2 * ffd, **kw),
        "ff_wo": dense_init(gen, ffd, d.d_model, **kw),
    }


def _slstm_cell(g: torch.Tensor, state):
    """One sLSTM step from the pre-activations g (B, H, 4 dh), fp32."""
    _, c, n, m = state
    zr, ir, fr, orr = g.chunk(4, dim=-1)
    zt, ot = torch.tanh(zr), torch.sigmoid(orr)
    lf = F.logsigmoid(fr)
    m_new = torch.maximum(lf + m[..., None], ir)
    ip = torch.exp(ir - m_new)
    fp = torch.exp(lf + m[..., None] - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new.amax(dim=-1)


def slstm_scan(params, x: torch.Tensor, cfg, state=None):
    """x: (B, L, d_model) -> (h_seq (B, L, d_model), final state (h, c, n,
    m)), one step at a time."""
    d = xlstm_dims(cfg)
    B, L, _ = x.shape
    xc = _causal_conv(x, params["conv_w"].to(x.dtype), params["conv_b"])
    gx = (xc @ params["wx"].to(x.dtype)).float() + params["b"]          # (B, L, 4 dm)
    gx = gx.reshape(B, L, d.n_heads, 4 * d.dh)
    r = params["r"].float()   # (a bf16 working copy promotes to the f32 state, as in JAX)
    if state is None:
        z = torch.zeros((B, d.n_heads, d.dh), device=x.device)
        state = (z, z, z, torch.full((B, d.n_heads), -10.0, device=x.device))
    hs = []
    for t in range(L):
        rec = torch.einsum("bhd,hde->bhe", state[0], r)
        state = _slstm_cell(gx[:, t] + rec, state)
        hs.append(state[0])
    hs = torch.stack(hs, dim=1).reshape(B, L, d.d_model).to(x.dtype)
    return hs, state


def _slstm_out(params, hs: torch.Tensor, cfg, split=None) -> torch.Tensor:
    hs = rms_norm(hs, params["norm"], _eps(cfg))
    g, u = _contract(hs, params["ff_wi"], split).chunk(2, dim=-1)
    return _produce(F.gelu(g, approximate="tanh") * u, params["ff_wo"], split)


def slstm_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    hs, _ = slstm_scan(params, x, cfg)
    return _slstm_out(params, hs, cfg)


def slstm_prefill(params, x: torch.Tensor, cfg):
    """Forward + final recurrent state + conv rolling buffer."""
    hs, final = slstm_scan(params, x, cfg)
    buf = x[:, x.shape[1] - (CONV_WIDTH - 1):, :].float()
    return _slstm_out(params, hs, cfg), final, buf


def slstm_decode(params, x: torch.Tensor, cfg, state, conv_buf: torch.Tensor, split=None):
    """x: (B, 1, d_model) -> (out (B, 1, d_model), state, new conv buffer);
    ``split`` as in ``mlstm_decode`` (the recurrent product stays whole)."""
    d = xlstm_dims(cfg)
    B = x.shape[0]
    hist = torch.cat([conv_buf.to(x.dtype), x[:, 0:1, :]], dim=1)
    xc = _conv_step(hist, params["conv_w"].to(x.dtype), params["conv_b"])
    gx = _contract(xc, params["wx"], split).float() + params["b"]
    rec = torch.einsum("bhd,hde->bhe", state[0], params["r"].float())
    state = _slstm_cell(gx.reshape(B, d.n_heads, 4 * d.dh) + rec, state)
    hs = state[0].reshape(B, 1, d.d_model).to(x.dtype)
    return _slstm_out(params, hs, cfg, split), state, hist[:, 1:, :]


def slstm_state_shapes(cfg, batch: int):
    d = xlstm_dims(cfg)
    return (
        (batch, d.n_heads, d.dh),  # h
        (batch, d.n_heads, d.dh),  # c
        (batch, d.n_heads, d.dh),  # n
        (batch, d.n_heads),        # m
        (batch, CONV_WIDTH - 1, d.d_model),  # conv buffer
    )
