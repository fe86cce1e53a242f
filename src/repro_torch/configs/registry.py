"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Dict

from .base import ALL_SHAPES, SHAPES, ArchConfig, ShapeSpec, shape_applicable
from .gemma2_9b import CONFIG as GEMMA2_9B
from .gemma_2b import CONFIG as GEMMA_2B
from .llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from .phi3_vision_4_2b import CONFIG as PHI3_VISION
from .qwen2_5_14b import CONFIG as QWEN2_5_14B
from .qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
from .qwen3_1_7b import CONFIG as QWEN3_1_7B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS
from .xlstm_125m import CONFIG as XLSTM_125M
from .zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        LLAMA4_MAVERICK,
        QWEN2_MOE,
        GEMMA2_9B,
        QWEN2_5_14B,
        GEMMA_2B,
        QWEN3_1_7B,
        XLSTM_125M,
        SEAMLESS,
        ZAMBA2_7B,
        PHI3_VISION,
    )
}

# short aliases for --arch
ALIASES = {
    "llama4": "llama4-maverick-400b-a17b",
    "qwen2-moe": "qwen2-moe-a2.7b",
    "gemma2": "gemma2-9b",
    "qwen2.5": "qwen2.5-14b",
    "gemma": "gemma-2b",
    "qwen3": "qwen3-1.7b",
    "xlstm": "xlstm-125m",
    "seamless": "seamless-m4t-large-v2",
    "zamba2": "zamba2-7b",
    "phi3v": "phi-3-vision-4.2b",
}


def get_arch(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)} "
                       f"or aliases {sorted(ALIASES)}")


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def grid():
    """All 40 (arch x shape) cells with applicability notes."""
    for arch in ARCHS.values():
        for shape in ALL_SHAPES:
            ok, note = shape_applicable(arch, shape)
            yield arch, shape, ok, note
