"""Architecture + run configuration system.

``ArchConfig`` captures every knob the 10 assigned architectures need.  Each
arch file in this package instantiates one (values straight from the
assignment table / public configs), plus a ``reduced()`` variant used by CPU
smoke tests.  ``ShapeSpec`` describes the assigned input shapes; the
(arch x shape) grid drives the dry-run and roofline analysis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | audio | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # --- attention variants
    rope_theta: float = 10_000.0
    qkv_bias: bool = False                  # qwen2.5
    qk_norm: bool = False                   # qwen3
    attn_logit_softcap: Optional[float] = None      # gemma2
    final_logit_softcap: Optional[float] = None     # gemma2
    sliding_window: Optional[int] = None            # gemma2 local layers
    layer_pattern: Tuple[str, ...] = ("global",)    # cycled over layers
    query_pre_attn_scalar: Optional[float] = None   # gemma2
    use_post_norms: bool = False            # gemma2 post-attn/post-ffw norms
    mlp_act: str = "silu"                   # 'gelu' => GeGLU (gemma)
    tie_embeddings: bool = False
    scale_embeddings: bool = False          # gemma: embed * sqrt(d)

    # --- MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: Optional[int] = None
    renorm_topk: bool = True

    # --- SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0                     # zamba2: shared attn period
    slstm_every: int = 0                    # xlstm: sLSTM every k-th block

    # --- encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontend stubs
    frontend: Optional[str] = None          # 'vision' | 'audio'
    n_frontend_tokens: int = 0

    # --- numerics / runtime
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    loss_chunk: int = 512                   # vocab-loss sequence chunking
    remat: str = "none"                     # none | block | full
    scan_chunk: int = 256                   # ssm/mlstm chunk length
    # --- perf knobs (§Perf hillclimb; defaults = paper-faithful baseline)
    attn_impl: str = "naive"                # naive | blocked (flash-style)
    attn_block_q: int = 2048
    attn_block_k: int = 1024
    mlstm_impl: str = "quadratic"           # quadratic | chunked
    moe_dispatch_groups: int = 0            # >1: DP-local token routing

    # ------------------------------------------------------------- utilities
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat_len = max(len(self.layer_pattern), 1)
        n_layers = max(2 * pat_len, 2)
        if self.slstm_every:
            n_layers = 2 * self.slstm_every      # two full groups
        if self.attn_every:
            n_layers = self.attn_every + 2       # one group + 2 tail layers
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            moe_d_ff=64 if self.n_experts else None,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            # generous capacity so smoke tests see no token drops (drop
            # behaviour is exercised separately in test_models_core)
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            sliding_window=32 if self.sliding_window else None,
            n_frontend_tokens=8 if self.frontend else 0,
            loss_chunk=64,
            scan_chunk=16,
            dtype="float32",
        )

    def flops_params(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6*N*D estimates."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp_dense = 3 * d * self.d_ff
        ff_moe = self.moe_d_ff or self.d_ff
        layers = 0
        if self.family == "moe":
            per = attn + 3 * d * ff_moe * self.top_k + 3 * d * ff_moe * self.n_shared_experts
            layers = self.n_layers * per
        elif self.family in ("dense", "vlm"):
            layers = self.n_layers * (attn + mlp_dense)
        elif self.family == "ssm":  # xlstm
            di = 2 * d
            mlstm = d * 2 * di + 3 * di * di + di * d
            layers = self.n_layers * mlstm
        elif self.family == "hybrid":
            di = 2 * d
            n_state = self.ssm_state
            mamba = d * (2 * di + 2 * n_state + di // self.ssm_head_dim) + di * d
            layers = self.n_layers * mamba + (attn + mlp_dense)  # one shared blk
        elif self.family == "audio":
            layers = (self.enc_layers + self.dec_layers) * (attn + mlp_dense)
            layers += self.dec_layers * attn  # cross-attention
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return layers + emb


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Which (arch x shape) cells run (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        # decode vs a 500k KV cache is linear-per-token; we run it for every
        # arch whose cache/state fits.  500k *prefill* would be quadratic for
        # pure global-attention archs — decode-only keeps the cell valid.
        return True, "decode-only; linear per token"
    return True, "ok"
