"""Mamba2's heads split over a model axis, on the CPU, against the JAX package.

A rank of a mesh whose "model" axis splits zamba2's Mamba2 heads computes
only its heads (``ssm.mamba2_sharded``): ``in_proj``'s z, x and dt columns
of its heads with B and C whole, its conv channels, its state, its slice of
the gated RMSNorm (whose sum of squares the ranks sum) and a partial sum of
the output through its ``out_proj`` rows.  Here the slices run in turn on
one device (``mamba2_slices``, ``mamba2_decode_slices``), cut as DTensor
cuts 8 heads over 1, 2, 3 and 4 ranks (ceil(8 / m) a rank: over 3, 3, 3
and 2; every cut is misaligned with ``in_proj``'s even column chunks,
148 columns over 2), and the sum of the slices is held against the
reference's ``mamba2_apply`` (output and final state, from zero and from a
given state) and ``mamba2_decode`` (output, state, conv buffer, the slices'
buffers written back to the even channel chunks a cache holds) within 1e-5
of the largest value, float32, the reduced zamba2's tail layer converted
from the reference's init by ``convert.model_from_jax``.  The gradients of
the sum of slices against ``jax.grad``, within 5e-5 likewise
(``GRAD_TOL``).  The plan of ``partitioning.regather`` (which rank sends
which piece) is checked on its own, and the fake world of 256 ranks (``tests/torch_mamba_fake_world.py``)
holds rank 0 of zamba2-7b's published width to its 7 heads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as fam
from repro.models import ssm as jssm
from repro_torch.models import partitioning as pt
from repro_torch.models import ssm

ARCH = "zamba2-7b"
TOL = 1e-5          # relative to the largest value of each compared tensor
# gradients: A_log's sums cancelling terms over every position (see
# test_alog_gradient_amplifies_a_tiny_perturbation); the unsplit port's own
# (``mamba2_apply``, m = 1 below) is 1.08e-5 off ``jax.grad`` here, its
# slices' 1.0-1.5e-5; the other gradients within 2e-6
GRAD_TOL = 5e-5
RNG = np.random.default_rng(27)
ROOT = Path(__file__).resolve().parents[1]


def _layer():
    """(jax cfg, port cfg, the reference's tail layer 0, the port's)."""
    jcfg, _, params, tm = fam.pair(ARCH)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["tail"]["mamba"])
    return jcfg, tm.cfg, jp, {k: v.detach() for k, v in tm.tail[0].mamba.items()}


def _close(got, want, tol=TOL):
    want = fam.f32(want)
    np.testing.assert_allclose(fam.f32(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _np(*shape, scale=0.5):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


SLICES = [1, 2, 3, 4]


@pytest.mark.parametrize("m", SLICES)
@pytest.mark.parametrize("from_state", [False, True])
def test_slices_match_reference_apply(m, from_state):
    jcfg, cfg, jp, tp = _layer()
    d = ssm.ssm_dims(cfg)
    x = _np(2, 32, cfg.d_model)
    h0 = _np(2, d.n_heads, d.head_dim, d.d_state, scale=0.1) if from_state else None
    want, want_h = jssm.mamba2_apply(jp, jnp.asarray(x), jcfg, chunk=cfg.scan_chunk,
                                     initial_state=None if h0 is None else jnp.asarray(h0),
                                     return_state=True)
    spans = pt._spans(d.n_heads, m)
    got, got_h = ssm.mamba2_slices(tp, torch.from_numpy(x), cfg, spans, chunk=cfg.scan_chunk,
                                   initial_state=None if h0 is None else torch.from_numpy(h0))
    _close(got, want)
    _close(got_h, want_h)


@pytest.mark.parametrize("m", SLICES)
def test_slices_match_reference_decode(m):
    """Each slice reads its conv channels from the even chunks of the cache's
    buffer (``regather_local``) and its buffer is written back to them."""
    jcfg, cfg, jp, tp = _layer()
    d = ssm.ssm_dims(cfg)
    x = _np(2, 1, cfg.d_model)
    state = _np(2, d.n_heads, d.head_dim, d.d_state, scale=0.1)
    buf = _np(2, ssm.CONV_WIDTH - 1, d.conv_dim)
    want = jssm.mamba2_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(state), jnp.asarray(buf))
    spans = pt._spans(d.n_heads, m)
    chunks = [[c] for c in pt._spans(d.conv_dim, m)]
    heads = [ssm.conv_channels(d, *s) for s in spans]
    tbuf = torch.from_numpy(buf)
    bufs = pt.regather_local([tbuf[..., a:b] for (a, b), in chunks], 2, chunks, heads)
    out, st, new = ssm.mamba2_decode_slices(tp, torch.from_numpy(x), cfg, spans,
                                            torch.from_numpy(state), bufs)
    back = torch.cat(pt.regather_local(new, 2, heads, chunks), dim=2)
    for g, w in zip((out, st, back), want):
        _close(g, w)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_slice_gradients_match_reference(m):
    """d/dparams and d/dx of sum(out * w) + sum(state * v) over the slices
    (each slice's parameters cut from the whole layer's, so B and C columns
    collect every slice's gradient) against ``jax.grad``; m = 1 is the
    unsplit ``mamba2_apply``."""
    jcfg, cfg, jp, tp = _layer()
    d = ssm.ssm_dims(cfg)
    x, w = _np(2, 32, cfg.d_model), _np(2, 32, cfg.d_model)
    v = _np(2, d.n_heads, d.head_dim, d.d_state)

    def jloss(p, xx):
        out, h = jssm.mamba2_apply(p, xx, jcfg, chunk=cfg.scan_chunk, return_state=True)
        return jnp.sum(out * w) + jnp.sum(h * v)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: t.clone().requires_grad_() for k, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, h = (ssm.mamba2_apply(leaves, tx, cfg, chunk=cfg.scan_chunk, return_state=True)
              if m == 1 else
              ssm.mamba2_slices(leaves, tx, cfg, pt._spans(d.n_heads, m), chunk=cfg.scan_chunk))
    ((out * torch.from_numpy(w)).sum() + (h * torch.from_numpy(v)).sum()).backward()
    _close(tx.grad, jgx, GRAD_TOL)
    for k, t in leaves.items():
        _close(t.grad, jg[k], GRAD_TOL)


def test_alog_gradient_amplifies_a_tiny_perturbation():
    """Why the layout tests (``test_torch_layout_dist.LEAF_TOL``) and phase
    layout (f) hold A_log's gradient to a limit of its own: the reduced
    zamba2's loss gradient, with the hidden states' gradient scaled by 1 +
    1e-7 noise, moves some layer's A_log gradient by more than 1e-5 of its
    largest value (but within 1e-4), and every other gradient by less."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import whole_chunks_loss

    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, "cpu", seed=0, trainable=True)
    batch = synthetic_batch(model, cfg, ShapeSpec("l", 32, 4, "train"), 0, "cpu")
    gen = torch.Generator().manual_seed(1)

    def grads(eps: float) -> dict:
        model.zero_grad()
        hidden = model.hidden_states(batch)
        if eps:
            noise = 1 + eps * torch.randn(hidden.shape, generator=gen)
            hidden.register_hook(lambda g: g * noise)
        labels = batch["labels"].to(torch.long)
        whole_chunks_loss(hidden, labels, model._head(), cfg.loss_chunk)[0].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    base, moved = grads(0.0), grads(1e-7)
    gap = {n: float((moved[n] - g).abs().max() / g.abs().max()) for n, g in base.items()}
    alog = max(v for n, v in gap.items() if n.endswith("A_log"))
    assert 1e-5 < alog <= 1e-4, alog
    assert max(v for n, v in gap.items() if not n.endswith("A_log")) < 1e-5, gap


def test_regather_plan():
    """in_proj's 296 columns in 2 even chunks (148) to the ranks' heads:
    each rank takes B and C (256..288) from itself where it holds them
    (rank 1) and from the lowest rank that does otherwise; written back,
    an index held by several ranks comes from the rank itself or the
    lowest; the emulation equals slicing."""
    d = ssm.SSMDims(64, 128, 8, 16, 16)
    have = [[c] for c in pt._spans(296, 2)]
    want = [ssm.in_proj_columns(d, *s) for s in pt._spans(8, 2)]
    assert want[0] == [(0, 64), (128, 192), (256, 288), (288, 292)]
    assert pt.regather_plan(have, want, 0) == [(0, 0, 64), (0, 128, 148), (1, 148, 192),
                                               (1, 256, 292)]
    assert pt.regather_plan(have, want, 1) == [(0, 64, 128), (1, 192, 288), (1, 292, 296)]
    back = pt.regather_plan(want, have, 0)
    assert back == [(0, 0, 64), (1, 64, 128), (0, 128, 148)]
    assert pt.regather_plan(want, have, 1) == [(0, 148, 192), (1, 192, 288), (0, 288, 292),
                                               (1, 292, 296)]
    t = torch.arange(296.0)[None].repeat(3, 1)
    got = pt.regather_local([t[:, a:b] for (a, b), in have], 1, have, want)
    for g, ranges in zip(got, want):
        assert torch.equal(g, torch.cat([t[:, a:b] for a, b in ranges], dim=1))
    assert torch.equal(torch.cat(pt.regather_local(got, 1, want, have), dim=1), t)
    # 8 heads over 16 ranks: ranks 8-15 hold none and want only B and C
    empty = [ssm.conv_channels(d, *s) for s in pt._spans(8, 16)]
    assert pt.regather_plan([[c] for c in pt._spans(160, 16)], empty, 15) == [
        (12, 128, 130), (13, 130, 140), (14, 140, 150), (15, 150, 160)]
    bufs = pt.regather_local([t[:, a:b] for a, b in pt._spans(160, 16)], 1,
                             [[c] for c in pt._spans(160, 16)], empty)
    assert [b.shape[1] for b in bufs] == [48] * 8 + [32] * 8
    assert torch.equal(torch.cat(pt.regather_local(bufs, 1, empty, [[c] for c in pt._spans(
        160, 16)]), dim=1), t[:, :160])
    assert pt.regather_local([t[:, :4], t[:, 4:8]], 1, [[(0, 4)], [(4, 8)]],
                             [[(0, 8)], [(8, 8)]])[1].shape == (3, 0)
    with pytest.raises(ValueError, match="no rank holds"):
        pt.regather_plan([[(0, 4)], [(5, 8)]], [[(0, 8)], []], 0)


def test_head_slice_layout():
    """A slice's parameters: heads [h0, h1)'s z, x and dt columns and B, C
    whole; their conv channels; their entries and rows."""
    _, cfg, _, tp = _layer()
    d = ssm.ssm_dims(cfg)
    p = ssm.head_slice(tp, cfg, 2, 5)
    P, N = d.head_dim, d.d_state
    assert p["in_proj"].shape == (d.d_model, 2 * 3 * P + 2 * N + 3)
    assert torch.equal(p["in_proj"][:, -3:], tp["in_proj"][:, 2 * d.d_inner + 2 * N + 2:][:, :3])
    assert p["conv_w"].shape == (ssm.CONV_WIDTH, 3 * P + 2 * N)
    assert p["out_proj"].shape == (3 * P, d.d_model) and p["A_log"].shape == (3,)
    assert ssm.slice_dims(p, cfg) == ssm.SSMDims(d.d_model, 3 * P, 3, P, N)
    assert ssm.slice_dims(tp, cfg) == d


def test_fake_world_rank_holds_its_heads():
    """zamba2-7b's Mamba2 layer at published width on rank 0 of 256 fake
    ranks (16 x 16, "fsdp"), forward and backward, then a prefill and a
    decode step of its caches: every SSD einsum holds 7 of the 112 heads,
    no product takes in_proj (3584 x 14576) or out_proj (7168 x 3584)
    whole, the rank's in_proj columns are its heads' 1031 (448 z, 448 x,
    128 B and C, 7 dt), and in_proj moves by all-to-all."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(Path(__file__).with_name(
        "torch_mamba_fake_world.py"))], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["einsum_heads"] == [7], out["einsum_heads"]
    whole = {(3584, 14576), (14576, 3584), (7168, 3584), (3584, 7168)}
    assert not whole & {tuple(s[-2:]) for s in out["mm_operands"] if len(s) >= 2}
    assert out["in_proj_cols"] == [1031], out["in_proj_cols"]
    assert out["all_to_all"] > 0 and out["all_reduce"] > 0
