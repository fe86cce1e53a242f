"""PyTorch and CUDA port of the Reservoir reproduction.

A second package beside the JAX reference ``repro``, with the same relative
module paths (``repro_torch/core/reuse_store.py`` mirrors
``repro/core/reuse_store.py``).  It imports ``torch``, numpy and the standard
library only: no ``jax`` and nothing of ``repro``.  Its entry points run on
the CUDA card unless the caller passes ``device="cpu"`` (see ``device.py``),
and every Pallas kernel on the ported path is a hand-written CUDA kernel for
Hopper (``kernels/csrc/``) with a plain PyTorch twin in ``kernels/ref.py``.
"""
