"""Plain reference of a dense decoder (Qwen2 / Qwen3): the last position's
logits of a batch of prompts, in float32, a layer at a time.

Plain ``torch`` only: no kernel, cache or batching of the program, and
nothing of it imported.  It follows the published architecture: a pre-norm
block of RMSNorm, grouped-query causal attention with rotary positions
(split halves, as Hugging Face's ``rotate_half``), optional q / k / v
biases (Qwen2) and per-head q / k RMSNorm before the rotation (Qwen3), and a
SwiGLU MLP; a final RMSNorm and the vocabulary projection (the embedding
when tied).  A norm's weight is ``1 + scale`` (``weights.py``).

Matrix products go through ``matmul``: ``f32_matmul`` (float32 with TF32
off, the reference) or ``fp8_matmul`` (the control: each operand rounded to
float8 e4m3 with a scale per row of the activations and per output column
of the weights, then multiplied in float32), the step below the bfloat16
the configuration serves in.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Mapping

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """float32 products at full precision (no TF32), restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def f32_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(a, -1) @ _fp8(w, 0)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, S, heads, D) at positions 0..S-1, halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = (f(ang).to(torch.float32)[None, :, None, :] for f in (torch.cos, torch.sin))
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: q (n, S, H, D), k and v (n, S, KV, D)."""
    n, s, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("nshd,nthd->nhst", q, k) / d ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("nhst,nthd->nshd", torch.softmax(scores, dim=-1), v)


def layer(x: torch.Tensor, w: Mapping[str, torch.Tensor], m: Mapping,
          matmul: Callable) -> torch.Tensor:
    n, s, d = x.shape
    h, kv, hd, eps = (m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
                      m["rms_norm_eps"])
    a = rms_norm(x, w["ln1"], eps)
    q, k, v = (matmul(a, w[f"attn.w{c}"]) for c in "qkv")
    if m["attention_bias"]:
        q, k, v = q + w["attn.bq"], k + w["attn.bk"], v + w["attn.bv"]
    q, k, v = q.view(n, s, h, hd), k.view(n, s, kv, hd), v.view(n, s, kv, hd)
    if m["qk_norm"]:
        q, k = rms_norm(q, w["attn.q_norm"], eps), rms_norm(k, w["attn.k_norm"], eps)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    x = x + matmul(attention(q, k, v).reshape(n, s, h * hd), w["attn.wo"])
    gate, up = matmul(rms_norm(x, w["ln2"], eps), w["mlp.wi"]).chunk(2, dim=-1)
    return x + matmul(torch.nn.functional.silu(gate) * up, w["mlp.wo"])


def last_logits(weights, m: Mapping, tokens: torch.Tensor, *,
                matmul: Callable = f32_matmul, block: int = 16) -> torch.Tensor:
    """(N, V) float32 logits of the last position of each of N prompts
    (tokens (N, S) on the device).  ``weights.by_group(name)`` gives a
    group's tensors ("embed", "head", "final_norm", "layers.i"), each
    taken to float32 here; prompts run ``block`` at a time inside a layer."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    with full_fp32(), torch.no_grad():
        emb = f32(weights.by_group("embed")["embed"])
        x = emb[tokens.long()]
        del emb
        for i in range(m["num_hidden_layers"]):
            w = {k: f32(t) for k, t in weights.by_group(f"layers.{i}").items()}
            x = torch.cat([layer(x[j:j + block], w, m, matmul)
                           for j in range(0, x.shape[0], block)])
            del w
        hl = rms_norm(x[:, -1], f32(weights.by_group("final_norm")["final_norm"]),
                      m["rms_norm_eps"])
        del x
        head = f32(weights.by_group("embed" if m["tie_word_embeddings"] else "head")
                   ["embed" if m["tie_word_embeddings"] else "head"])
        return matmul(hl, head.T)
