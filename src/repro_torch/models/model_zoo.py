"""Model zoo: build the right model class for an ArchConfig.

Port of ``repro/models/model_zoo.py``: every architecture of the registry.
"""
from __future__ import annotations

from torch import nn

from ..device import DeviceLike
from .encdec import EncDecModel
from .hybrid import HybridModel
from .transformer import DecoderLM
from .xlstm_model import XLSTMModel


def model_class(cfg) -> type:
    """The family's model class, as the reference's ``build_model`` picks it."""
    if cfg.is_encdec:
        return EncDecModel
    if cfg.family == "hybrid":
        return HybridModel
    if cfg.family == "ssm":
        return XLSTMModel
    return DecoderLM  # dense | moe | vlm


def build_model(cfg, device: DeviceLike = None, *, seed: int = 0,
                trainable: bool = False) -> nn.Module:
    """The model for ``cfg`` on ``device`` (None: the CUDA card), weights
    drawn from ``seed``.  ``trainable``: the training construction (fp32
    master parameters that take gradients), every family's."""
    return model_class(cfg)(cfg, device, seed=seed, trainable=trainable)
