"""The fused norm and rotary entry points (``ops.rms_norm``, ``ops.qk_rope``)
on the CPU, and the dispatch that decides where the model uses them.

On the CPU both ops run their plain versions, which must give, bit for bit,
what the model's layers computed before the kernels existed: the float32
RMSNorm chain, the bf16 residual and bias adds, and the split-halves
rotation (copied below as ``_old_*``).  The dispatch (``ops.norm_engages``,
``ops.rope_engages``) keeps the plain chain for DTensors, for anything that
requires grad, for float32 activations and for widths the kernels do not
take; the device test is forced here (``ops._on_card``) so that the rest of
the rule, and the model's fused route, run on the CPU.  The kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``).  Imports no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import norm_rope, ops, ref
from repro_torch.models import DecoderLM, layers


# ----------------------------------------------------- the old composition
def _old_rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


def _old_rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _old_apply_rope(x, positions, theta):
    freqs = _old_rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _old_project(flat, bias, norm, heads, positions, theta, eps):
    """project_q's / project_kv's chain on a (B, S, heads * D) projection."""
    if bias is not None:
        flat = flat + bias.to(flat.dtype)
    x = flat.reshape(*flat.shape[:-1], heads, flat.shape[-1] // heads)
    if norm is not None:
        x = _old_rms_norm(x, norm, eps)
    return _old_apply_rope(x, positions, theta)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


# (rows, d, dtype, residual)
NORM_CASES = {
    "head128": ((64, 16), 128, torch.bfloat16, False),
    "head256": ((32, 8), 256, torch.bfloat16, False),
    "d2048": ((2, 37), 2048, torch.bfloat16, False),
    "d2048_residual": ((2, 37), 2048, torch.bfloat16, True),
    "d5120_residual": ((3, 5), 5120, torch.bfloat16, True),
    "decode_residual": ((4, 1), 2048, torch.bfloat16, True),
    "f32": ((5, 7), 64, torch.float32, False),
    "f32_residual": ((5, 7), 64, torch.float32, True),
    "width_12": ((6,), 12, torch.bfloat16, False),
}

# (B, S, H, KV, D, bias, qk-norm, positions: "prefill" (1, S) or "decode" (B, 1))
ROPE_CASES = {
    "qwen3_prefill": (2, 24, 16, 8, 128, False, True, "prefill"),
    "qwen25_prefill": (2, 24, 40, 8, 128, True, False, "prefill"),
    "both": (1, 9, 4, 2, 64, True, True, "prefill"),
    "neither": (3, 5, 4, 1, 256, False, False, "prefill"),
    "qwen3_decode": (5, 1, 16, 8, 128, False, True, "decode"),
    "qwen25_decode": (5, 1, 40, 8, 128, True, False, "decode"),
    "gemma_d256_decode": (3, 1, 8, 1, 256, False, False, "decode"),
}


def _norm_case(case):
    lead, d, dt, with_res = NORM_CASES[case]
    gen = _gen(len(case))
    x = _randn(gen, *lead, d, dtype=dt)
    scale = _randn(gen, d, dtype=torch.float32, scale=0.1)
    res = _randn(gen, *lead, d, dtype=dt, scale=3.0) if with_res else None
    return x, scale, res


def _rope_case(case):
    B, S, H, KV, D, bias, norm, kind = ROPE_CASES[case]
    gen = _gen(len(case) + 100)
    q, k = _randn(gen, B, S, H * D), _randn(gen, B, S, KV * D)
    extra = {}
    if bias:
        extra["bq"], extra["bk"] = _randn(gen, H * D, scale=0.5), _randn(gen, KV * D, scale=0.5)
    if norm:
        extra["q_norm"] = _randn(gen, D, dtype=torch.float32, scale=0.1)
        extra["k_norm"] = _randn(gen, D, dtype=torch.float32, scale=0.1)
    if kind == "prefill":
        pos = torch.arange(S)[None, :]
    else:
        pos = torch.randint(0, 4096, (B, 1), generator=gen)
    return q, k, pos, extra, (H, KV)


OP_CASES = [("norm", c) for c in NORM_CASES] + [("rope", c) for c in ROPE_CASES]


@pytest.mark.parametrize("op,case", OP_CASES, ids=[f"{o}-{c}" for o, c in OP_CASES])
def test_ops_give_the_old_composition_bit_for_bit(op, case):
    """On the CPU, ``ops.rms_norm`` (with and without its residual) and
    ``ops.qk_rope`` (with and without bias and qk-norm, prefill and decode
    positions) equal the layers' old chain exactly."""
    eps, theta = 1e-6, 1_000_000.0
    if op == "norm":
        x, scale, res = _norm_case(case)
        if res is None:
            assert torch.equal(ops.rms_norm(x, scale, eps), _old_rms_norm(x, scale, eps))
            return
        y, total = ops.rms_norm(x, scale, eps, residual=res)
        want_total = res + x
        assert torch.equal(total, want_total)
        assert torch.equal(y, _old_rms_norm(want_total, scale, eps))
        return
    q, k, pos, extra, (H, KV) = _rope_case(case)
    B, S = q.shape[:2]
    got_q, got_k = ops.qk_rope(q.view(B, S, H, -1), k.view(B, S, KV, -1), pos, theta, eps=eps,
                               **extra)
    want_q = _old_project(q, extra.get("bq"), extra.get("q_norm"), H, pos, theta, eps)
    want_k = _old_project(k, extra.get("bk"), extra.get("k_norm"), KV, pos, theta, eps)
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)


# ------------------------------------------------------------ the dispatch
@pytest.fixture
def on_card(monkeypatch):
    """Treat every tensor as if it lay on the card: the rest of the
    dispatch's rule decides."""
    monkeypatch.setattr(ops, "_on_card", lambda x: True)


def _dtensor(t):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as tmesh

    mesh = tmesh.make_host_mesh(device="cpu")
    return distribute_tensor(t, mesh, (Replicate(),) * mesh.ndim)


def _norm_inputs(kind):
    gen = _gen(3)
    d = 12 if kind == "width_12" else 64
    x = _randn(gen, 4, 5, d, dtype=torch.float32 if kind == "f32" else torch.bfloat16)
    scale = _randn(gen, d, dtype=torch.float32, scale=0.1)
    res = _randn(gen, 4, 5, d) if kind == "residual" else None
    if kind == "dtensor":
        x, scale = _dtensor(x), _dtensor(scale)
    elif kind == "x_grad":
        x = x.float().requires_grad_().to(torch.bfloat16)
    elif kind == "scale_grad":
        scale = scale.requires_grad_()
    elif kind == "strided":
        x = _randn(gen, 4, 5, 2 * d)[..., ::2]
    elif kind == "bf16_scale":
        scale = scale.to(torch.bfloat16)
    return x, scale, res


NORM_DISPATCH = {"bf16": True, "residual": True, "dtensor": False, "x_grad": False,
                 "scale_grad": False, "f32": False, "width_12": False, "strided": False,
                 "bf16_scale": False}


@pytest.mark.parametrize("kind", sorted(NORM_DISPATCH))
def test_norm_dispatch_keeps_the_plain_chain(kind, on_card, monkeypatch):
    """``layers.rms_norm`` and ``layers.add_rms_norm`` call ``ops.rms_norm``
    only for plain bf16 rows of a width that is a multiple of 8 with nothing
    requiring grad; in every other case the plain chain, with its autograd."""
    calls = []
    real = ops.rms_norm
    monkeypatch.setattr(ops, "rms_norm", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x, scale, res = _norm_inputs(kind)
    want = NORM_DISPATCH[kind]
    assert ops.norm_engages(x, scale, res) is want
    if res is None:
        y = layers.rms_norm(x, scale, 1e-6)
        plain = ref.rms_norm_ref(x, scale, 1e-6)
    else:
        y, total = layers.add_rms_norm(x, res, scale, 1e-6)
        plain, want_total = ref.rms_norm_ref(x, scale, 1e-6, residual=res)
        assert torch.equal(total, want_total)
    assert len(calls) == int(want)
    local = (lambda t: t.full_tensor()) if kind == "dtensor" else (lambda t: t)
    assert torch.equal(local(y).detach(), local(plain).detach())
    if kind.endswith("grad"):
        assert y.requires_grad


def _rope_inputs(kind):
    gen = _gen(4)
    D = 24 if kind == "width_24" else 32
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    x = _randn(gen, 2, 5, 64, dtype=dt)
    pos = torch.arange(5)[None, :]
    params = [_randn(gen, 64, 4 * D, dtype=dt), _randn(gen, D, dtype=torch.float32)]
    if kind == "dtensor":
        x = _dtensor(x)
    elif kind == "weight_grad":
        params[0] = params[0].float().requires_grad_()
    elif kind == "norm_grad":
        params[1] = params[1].requires_grad_()
    elif kind == "int32_positions":
        pos = pos.to(torch.int32)
    return x, pos, D, params


ROPE_DISPATCH = {"bf16": True, "dtensor": False, "weight_grad": False, "norm_grad": False,
                 "f32": False, "width_24": False, "int32_positions": False}


@pytest.mark.parametrize("kind", sorted(ROPE_DISPATCH))
def test_rope_dispatch_keeps_the_plain_chain(kind, on_card):
    """``ops.rope_engages`` takes plain bf16 inputs with nothing requiring
    grad, a head width that is a multiple of 16 and int64 positions."""
    x, pos, D, params = _rope_inputs(kind)
    assert ops.rope_engages(x, pos, D, *params) is ROPE_DISPATCH[kind]


def test_nothing_engages_off_the_card():
    x, scale, _ = _norm_inputs("bf16")
    assert not ops.norm_engages(x, scale)
    xr, pos, D, params = _rope_inputs("bf16")
    assert not ops.rope_engages(xr, pos, D, *params)


def test_launch_counts_list_the_fused_kernels():
    counts = ops.launch_counts()
    assert {"rms_norm", "qk_rope"} <= set(counts)
    norm_rope.LAUNCHES["rms_norm"] = 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["rms_norm"] == 0 and ops.launch_counts()["qk_rope"] == 0


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("d", [8, 64, 96, 128, 256, 264, 2048, 3072, 5120, 7168, 8192, 32768])
def test_norm_plan_covers_the_row(d):
    p = norm_rope.norm_plan(d)
    assert p["lanes"] * p["vec_per_lane"] * 8 >= d
    assert (p["lanes"] - 1) * p["vec_per_lane"] * 8 < d or p["lanes"] & (p["lanes"] - 1) == 0
    assert p["threads"] % 32 == 0 and p["threads"] <= norm_rope.MAX_THREADS
    if p["lanes"] <= 32:   # a power of two inside a warp, whole rows to a block
        assert p["lanes"] & (p["lanes"] - 1) == 0 and p["threads"] % p["lanes"] == 0
    else:                  # a block a row
        assert p["lanes"] == p["threads"]


@pytest.mark.parametrize("d", [0, 12, 36, norm_rope.NORM_MAX_D + 8])
def test_norm_plan_refuses_other_widths(d):
    with pytest.raises(ValueError):
        norm_rope.norm_plan(d)


@pytest.mark.parametrize("D,heads", [(16, 3), (64, 33), (96, 64), (112, 40), (128, 24),
                                     (128, 48), (256, 24), (512, 2)])
def test_rope_plan(D, heads):
    p = norm_rope.rope_plan(D, heads)
    assert p["lanes"] >= D // 16 and 32 % p["lanes"] == 0
    assert p["threads"] % 32 == 0 and p["threads"] <= norm_rope.ROPE_THREADS
    assert p["threads"] >= min(heads * p["lanes"], norm_rope.ROPE_THREADS)


# ------------------------------------------------ the model's fused route
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-14b", "gemma2-9b"])
def test_forced_fused_route_keeps_the_model_bit_for_bit(arch, monkeypatch):
    """A reduced bf16 model's prefill and decode step through the fused
    route (``ops.rms_norm`` with the residual, ``ops.qk_rope``; on the CPU
    their plain versions) equal the plain route's logits and cache bit for
    bit, with one norm call a norm site (the second residual add fused)
    and one ``qk_rope`` a layer."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    model = DecoderLM(cfg, "cpu", seed=3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 11), generator=_gen(5))

    def run():
        logits, cache = model.prefill({"tokens": tokens}, 16)
        cache = {n: c.clone() for n, c in cache.items()}
        step, cache = model.decode_step(tokens[:, -1:], cache, 11)
        return logits, step, cache

    plain = run()
    calls = {"rms_norm": 0, "qk_rope": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    fused = run()
    assert torch.equal(fused[0], plain[0]) and torch.equal(fused[1], plain[1])
    assert all(torch.equal(fused[2][n], plain[2][n]) for n in plain[2])
    L = cfg.n_layers
    norms_a_pass = (2 + 2 * int(cfg.use_post_norms)) * L + 1
    assert calls == {"rms_norm": 2 * norms_a_pass, "qk_rope": 2 * L}
