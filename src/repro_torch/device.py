"""Device selection and float32 matmul precision for the port.

``None`` means the CUDA card.  Without one, the entry points refuse to run
rather than carry on silently on the CPU: the caller asks for the CPU with
``device="cpu"`` (as the CPU tests do).  A model built on ``"meta"`` has
its parameters' names, shapes and dtypes and no values (for deriving a
layout's shardings at a width no host holds).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for draws on ``device`` (a meta draw
    takes a CPU generator and draws nothing)."""
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


@contextlib.contextmanager
def fp32_matmul() -> Iterator[None]:
    """Run the float32 matmuls inside at full fp32 precision, whatever the
    process-wide setting, and restore that setting on exit.

    The hash kernels sum in fp32; a probe or cosine computed in TF32 (or
    bf16) would pick other buckets and winners than they do.  The setting is
    process-wide, so a matmul another thread runs meanwhile sees it too.
    """
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
