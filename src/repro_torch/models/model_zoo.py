"""Model zoo: build the right model class for an ArchConfig.

Port of ``repro/models/model_zoo.py``.  The port has the dense decoder so
far; the other families raise and name the slice that brings them.
"""
from __future__ import annotations

from ..device import DeviceLike
from .transformer import DecoderLM

_LATER = {
    "moe": "the MoE slice",
    "ssm": "the SSM/xLSTM slice",
    "hybrid": "the hybrid (SSM + attention) slice",
    "audio": "the encoder-decoder slice",
    "vlm": "the vision-frontend slice",
}


def build_model(cfg, device: DeviceLike = None, *, seed: int = 0) -> DecoderLM:
    """The model for ``cfg`` on ``device`` (None: the CUDA card), weights
    drawn from ``seed``."""
    family = "audio" if cfg.is_encdec else cfg.family
    if family != "dense":
        raise NotImplementedError(
            f"{cfg.name} ({family}) is not ported yet; it comes with "
            f"{_LATER.get(family, 'a later slice')} of the port")
    return DecoderLM(cfg, device, seed=seed)
