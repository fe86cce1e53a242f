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

The layer's work splits over its heads: ``mamba2_gate`` (the scan of the
heads a parameter dict holds), ``sum_squares`` and ``gated_out`` (the
gated RMSNorm over the whole d_inner and the heads' rows of ``out_proj``)
are what one rank of a "model" axis runs on its heads (``head_slice``'s
layout), and ``mamba2_apply`` / ``mamba2_decode`` their one-slice case.
``mamba2_sharded`` runs a layer so on a mesh; ``mamba2_slices`` /
``mamba2_decode_slices`` compute every slice in turn on one device.

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

from . import partitioning as pt
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


def _split_in(params, x: torch.Tensor, d: SSMDims, proj: Optional[torch.Tensor] = None):
    """z, xbc, dt of ``x @ in_proj`` (``proj`` where it is given)."""
    if proj is None:
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


def slice_dims(params, cfg) -> SSMDims:
    """The dims of the heads that ``params`` holds: all of ``cfg``'s, or a
    slice's (``head_slice``), whose d_inner is its heads' columns."""
    P = getattr(cfg, "ssm_head_dim", 64)
    h = params["A_log"].shape[0]
    return SSMDims(cfg.d_model, h * P, h, P, cfg.ssm_state)


def in_proj_columns(d: SSMDims, h0: int, h1: int) -> list:
    """The (start, stop) ranges of ``in_proj``'s columns that heads [h0, h1)
    read, in order: their z and x columns, B and C whole, their dt."""
    P, n, bc = d.head_dim, d.d_inner, 2 * d.d_inner
    dt = bc + 2 * d.d_state
    return [(h0 * P, h1 * P), (n + h0 * P, n + h1 * P), (bc, dt), (dt + h0, dt + h1)]


def conv_channels(d: SSMDims, h0: int, h1: int) -> list:
    """The conv channels of heads [h0, h1): their x channels, B and C whole."""
    P, n = d.head_dim, d.d_inner
    return [(h0 * P, h1 * P), (n, n + 2 * d.d_state)]


def head_ranges(name: str, d: SSMDims, h0: int, h1: int) -> Tuple[int, list]:
    """(the dim of parameter ``name`` that holds heads [h0, h1), their ranges
    of it): the layout of a slice's parameters."""
    P = d.head_dim
    if name == "in_proj":
        return 1, in_proj_columns(d, h0, h1)
    if name in ("conv_w", "conv_b"):
        return (1 if name == "conv_w" else 0), conv_channels(d, h0, h1)
    if name in ("A_log", "dt_bias", "D"):
        return 0, [(h0, h1)]
    return 0, [(h0 * P, h1 * P)]              # norm, out_proj


def head_slice(params, cfg, h0: int, h1: int) -> dict:
    """The parameters of heads [h0, h1) (``head_ranges``), sliced from the
    whole layer's: what a rank of a model axis split over the heads holds."""
    d = ssm_dims(cfg)
    out = {}
    for name, t in params.items():
        dim, ranges = head_ranges(name, d, h0, h1)
        out[name] = torch.cat([t.narrow(dim, a, b - a) for a, b in ranges], dim=dim)
    return out


def mamba2_gate(params, x_in: torch.Tensor, cfg, chunk: int = 256,
                initial_state: Optional[torch.Tensor] = None,
                proj: Optional[torch.Tensor] = None):
    """The chunked SSD scan of the heads that ``params`` holds (all, or a
    slice's): x_in (B, L, d_model) -> (the gated output y * silu(z) (B, L,
    heads x head_dim) in x_in's dtype, the final state (B, heads, P, N)
    fp32): ``mamba2_apply`` up to its gated RMSNorm.  ``proj``: x_in's
    product with their in_proj columns, where the caller has it."""
    d = slice_dims(params, cfg)
    B_, L, _ = x_in.shape
    z, xbc, dt_raw = _split_in(params, x_in, d, proj)
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
    return y * F.silu(z), h


def sum_squares(g: torch.Tensor) -> torch.Tensor:
    """A slice's share of the gated RMSNorm's mean square: the fp32 sum of
    squares of its columns of ``g`` (keepdim)."""
    return g.float().square().sum(dim=-1, keepdim=True)


def gated_out(params, g: torch.Tensor, cfg, ss: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The output of the heads that ``params`` holds, from their gated
    output ``g``: normalised over the whole d_inner, scaled by their slice
    of ``norm``, times their rows of ``out_proj``, a partial sum over the
    slices.  ``ss``: the sum of squares over every column (the slices'
    ``sum_squares`` summed), divided by d_inner; None where ``params`` holds
    every head (``rms_norm``'s own mean)."""
    eps = getattr(cfg, "norm_eps", 1e-6)
    if ss is None:
        y = rms_norm(g, params["norm"], eps)
    else:
        y = g.float() * torch.rsqrt(ss / ssm_dims(cfg).d_inner + eps)
        y = (y * (1.0 + params["norm"].float())).to(g.dtype)
    return y @ params["out_proj"].to(g.dtype)


def mamba2_apply(params, x_in: torch.Tensor, cfg, chunk: int = 256,
                 initial_state: Optional[torch.Tensor] = None, return_state: bool = False):
    """Chunked SSD forward: x_in (B, L, d_model) -> (B, L, d_model) [and the
    final state (B, H, P, N) fp32]."""
    g, h = mamba2_gate(params, x_in, cfg, chunk, initial_state)
    out = gated_out(params, g, cfg)
    if return_state:
        return out, h
    return out


def mamba2_decode_gate(params, x_in: torch.Tensor, cfg, state: torch.Tensor,
                       conv_buf: torch.Tensor, proj: Optional[torch.Tensor] = None):
    """One-token decode of the heads that ``params`` holds (all, or a
    slice's): state (B, heads, P, N) f32, conv_buf (B, W-1, their conv
    channels) -> (the gated output (B, heads x head_dim), new state, new
    buffer): ``mamba2_decode`` up to its gated RMSNorm.  ``proj`` as in
    ``mamba2_gate``."""
    d = slice_dims(params, cfg)
    B_ = x_in.shape[0]
    z, xbc, dt_raw = _split_in(params, x_in[:, 0, :], d, None if proj is None else proj[:, 0])
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
    return y * F.silu(z), state, hist[:, 1:, :]


def mamba2_decode(params, x_in: torch.Tensor, cfg, state: torch.Tensor,
                  conv_buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. state: (B, H, P, N) f32; conv_buf: (B, W-1,
    conv_dim).  Returns (out (B, 1, d_model), new state, new buffer)."""
    g, state, buf = mamba2_decode_gate(params, x_in, cfg, state, conv_buf)
    return gated_out(params, g, cfg)[:, None, :], state, buf


def mamba2_slices(params, x_in: torch.Tensor, cfg, spans, chunk: int = 256,
                  initial_state: Optional[torch.Tensor] = None):
    """``mamba2_apply`` as a model axis split over the heads computes it, on
    one device: each of ``spans``' head slices (h0, h1) through
    ``mamba2_gate`` and ``gated_out`` with the slices' shared sum of squares,
    the partial outputs summed -> (out, final state)."""
    slices = [head_slice(params, cfg, h0, h1) for h0, h1 in spans]
    gates = [mamba2_gate(p, x_in, cfg, chunk, None if initial_state is None
                         else initial_state[:, h0:h1]) for p, (h0, h1) in zip(slices, spans)]
    ss = sum(sum_squares(g) for g, _ in gates)
    out = sum(gated_out(p, g, cfg, ss) for p, (g, _) in zip(slices, gates))
    return out, torch.cat([h for _, h in gates], dim=1)


def mamba2_decode_slices(params, x_in: torch.Tensor, cfg, spans, state: torch.Tensor,
                         conv_bufs: list):
    """``mamba2_decode`` split over ``spans``' head slices on one device, each
    slice's conv buffer in its own layout (``conv_channels``) -> (out, new
    state, each slice's new buffer)."""
    slices = [head_slice(params, cfg, h0, h1) for h0, h1 in spans]
    steps = [mamba2_decode_gate(p, x_in, cfg, state[:, h0:h1], buf)
             for p, (h0, h1), buf in zip(slices, spans, conv_bufs)]
    ss = sum(sum_squares(g) for g, _, _ in steps)
    out = sum(gated_out(p, g, cfg, ss) for p, (g, _, _) in zip(slices, steps))
    return out[:, None, :], torch.cat([st for _, st, _ in steps], dim=1), \
        [buf for _, _, buf in steps]


def mamba2_sharded(params, ln: torch.Tensor, x: torch.Tensor, cfg, *, chunk: int = 256,
                   ssm: Optional[torch.Tensor] = None, conv: Optional[torch.Tensor] = None,
                   step: bool = False) -> torch.Tensor:
    """One Mamba2 layer, ``mamba2_apply(params, rms_norm(x, ln))``, on a mesh:
    ``x`` a DTensor (batch over the batch axes), the parameters DTensors
    placed as ``launch/shardings.py`` places them (``in_proj``'s columns and
    ``out_proj``'s rows over "model", the rest replicated).  Each rank
    computes only its heads of the "heads" axis (DTensor's chunks: ceil(H /
    m) a rank, the last ranks fewer or none) on its batch shard:

    * ``in_proj``'s columns, in even chunks over "model", reach the rank's
      heads (their z, x and dt columns, B and C whole) by one all-to-all
      (``partitioning.regather``): the weight's columns, gathered over the
      batch axes, where the rank has at least as many tokens as d_model (a
      train step, a prefill), else the product's (a decode step: 8 x 1031
      values a layer, not 3584 x 1031); the gradient goes back, B and C
      summed over "model";
    * ``out_proj``'s rows likewise where its chunks are not the heads'; the
      replicated vectors are sliced;
    * the gated RMSNorm's sum of squares is summed over "model";
    * the rank's output is a partial sum, reduced over "model" into x's
      placements; x's gradient is reduced likewise.

    With ``ssm`` and ``conv`` (a prefill's or, ``step``, a decode step's
    cache leaves: (B, H, P, N) with heads over "model", (B, W-1, conv_dim)
    with channels over "model"), the rank reads its heads' state in place
    and its conv channels (x and B/C, moved from the even chunks), and
    writes its new state and conv tail back to its own chunks; the caches
    are never gathered.

    A decode step under ``partitioning.embed_split`` (a batch the batch axes
    do not divide) keeps ``in_proj`` and ``out_proj`` as stored, their embed
    dim split over the batch axes as x's is: the rank contracts its chunk
    of the normed x against its rows of ``in_proj``'s columns, the partial
    products are summed over the batch axes before the regather to the
    heads, and ``out_proj``'s columns give the rank its chunk of the
    output's d.  -> the output, a DTensor of x's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    d = ssm_dims(cfg)
    i, m, me = pt.axis_rank(mesh, "heads")
    spans = pt._spans(d.n_heads, m)
    sp = pt.local_split() if step else None
    xp = pt.placements(pt.fit(pt.spec("batch", None, None), x.shape, mesh), mesh)
    if sp is not None:   # x and the output: their chunk of d over the batch axes
        xp = sp.placements(x.ndim - 1, xp)
    # a replicated weight's gradient: partial over the batch shards and the
    # ranks' heads
    grad = [Partial() if p.is_shard() or j == i else Replicate() for j, p in enumerate(xp)]
    xg = tuple(Partial() if j == i else p for j, p in enumerate(xp))

    def local(w: torch.Tensor, dim: int):
        """(w as this rank's tensor, whole but over "model", each rank's
        ranges of ``dim``: None where it is whole)."""
        sharded = i is not None and w.placements[i].is_shard(dim)
        keep = tuple(p if (j == i and sharded) or (sp is not None and j in sp.dims)
                     else Replicate() for j, p in enumerate(w.placements))
        g = tuple(keep[j] if j == i and sharded else grad[j] for j in range(len(grad)))
        have = [[s] for s in pt._spans(w.shape[dim], m)] if sharded else None
        return w.redistribute(mesh, keep).to_local(grad_placements=g), have

    def heads_of(name: str) -> list:
        return [head_ranges(name, d, *s)[1] for s in spans]

    if sp is None:
        xn = rms_norm(x.redistribute(mesh, xp).to_local(grad_placements=xg),
                      local(ln, 0)[0], cfg.norm_eps)
    else:   # normed over the whole d: its mean square summed over the batch axes
        xn = rms_norm(x, ln, cfg.norm_eps).redistribute(mesh, xp).to_local()
    p, proj = {}, None
    for name, w in params.items():
        if name in ("in_proj", "out_proj"):
            w = pt.at_use(w, x.dtype)
        dim = head_ranges(name, d, 0, 0)[0]
        t, have = local(w, dim)
        if name == "in_proj" and sp is not None:
            proj = pt.regather(sp.sum(xn @ t), mesh, i, xn.ndim - 1, have, heads_of(name))
            p[name] = None
        elif name == "in_proj" and xn.numel() < xn.shape[-1] ** 2:   # fewer tokens than d_model
            proj = pt.regather(xn @ t, mesh, i, xn.ndim - 1, have, heads_of(name))
            p[name] = None
        else:
            p[name] = pt.regather(t, mesh, i, dim, have, heads_of(name))
    heads, chans = [[s] for s in spans], heads_of("conv_b")
    if step:
        g, st, buf = mamba2_decode_gate(p, xn, cfg, _read(ssm, i, m, 1, heads),
                                        _read(conv, i, m, 2, chans), proj=proj)
    else:
        g, st = mamba2_gate(p, xn, cfg, chunk, proj=proj)
    out = gated_out(p, g, cfg, None if i is None else pt.all_sum(sum_squares(g), mesh, i))
    if step:
        out = out[:, None, :]
    if ssm is not None:
        if not step:
            tail = slice(xn.shape[1] - (CONV_WIDTH - 1), None)
            buf = _split_in(p, xn[:, tail], slice_dims(p, cfg),
                            None if proj is None else proj[:, tail])[1]
        _write(ssm, st, i, m, 1, heads)
        _write(conv, buf, i, m, 2, chans)
    y = DTensor.from_local(out, mesh, xg, shape=x.shape, stride=pt.contiguous_strides(x.shape))
    return y.redistribute(mesh, xp)


def _layout(cache: torch.Tensor, i: Optional[int], m: int, dim: int) -> Optional[list]:
    """Each rank's ranges of ``dim`` of a cache leaf (DTensor's chunks where
    it is sharded over mesh dim ``i``), or None where it is whole."""
    if i is None or not cache.placements[i].is_shard(dim):
        return None
    return [[s] for s in pt._spans(cache.shape[dim], m)]


def _read(cache: torch.Tensor, i, m: int, dim: int, want: list) -> torch.Tensor:
    """The rank's ``want`` ranges of a cache leaf's ``dim``, read from the
    ranks' chunks (a local view where the rank holds them)."""
    return pt.regather(cache._local_tensor, cache.device_mesh, i, dim,
                       _layout(cache, i, m, dim), want)


def _write(cache: torch.Tensor, new: torch.Tensor, i, m: int, dim: int, have: list) -> None:
    """Write each rank's ``new`` (its ``have`` ranges of ``dim``) into the
    cache leaf's chunks, each rank into its own shard only."""
    want = _layout(cache, i, m, dim) or [[(0, cache.shape[dim])]] * m
    cache._local_tensor.copy_(pt.regather(new, cache.device_mesh, i, dim, have, want))


def mamba2_state_shapes(cfg, batch: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    d = ssm_dims(cfg)
    return (batch, d.n_heads, d.head_dim, d.d_state), (batch, CONV_WIDTH - 1, d.conv_dim)
