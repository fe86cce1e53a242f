"""Wrapper of the prefill attention kernel (``csrc/flash_attention.cu``).

Port of the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``.
For a CUDA tensor the wrapper checks its inputs, allocates the output,
launches the hand-written kernel on the current stream and counts the
launch; for a CPU tensor it runs the plain version ``ref.flash_attention_ref``.
There is no fallback: a CUDA input either launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref

#: launches of the kernel in this process (``ops.reset_launch_counts``)
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)       # the kernel's compiled head widths
DTYPES = (torch.float32, torch.bfloat16)


def check_vector_rows(name: str, x: torch.Tensor) -> None:
    """The kernels read rows 16 bytes at a time: the last axis contiguous,
    every other stride and the base 16-byte aligned."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) != 1 or any(s % per16 for s in x.stride()[:-1])
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned "
                         f"(strides {x.stride()})")


def check_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_dims: int) -> None:
    """Shapes, dtypes and devices shared by the two attention wrappers."""
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)} "
                         "(same batch and head width, H a multiple of KV)")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError("q, k, v must be float32 or bfloat16 (k and v alike)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA prefill attention: q (B, S, H, D), k/v (B, T, KV, D) -> (B, S, H,
    D) in q's dtype, fp32 inside.  ``causal`` masks t > s, ``window`` masks
    t <= s - window, ``softcap`` caps logits at c*tanh(s/c), ``scale``
    defaults to 1/sqrt(D).  q, k, v share one dtype."""
    check_attention(q, k, v, 4)
    if q.dtype != k.dtype:
        raise TypeError("q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError("window must be a positive number of positions")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not compiled; the kernel takes {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_vector_rows(name, x)
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, KV, D, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            int(causal), -1 if window is None else int(window),
            -1.0 if softcap is None else float(softcap), scale,
            int(q.dtype == torch.bfloat16), stream), "flash_attention_launch")
    LAUNCHES["flash_attention"] += 1
    return out
