"""Carry state from the JAX package into the port.

The state of the ported slice is the LSH family and the reuse store's
contents.  Both arrive as numpy arrays (``np.asarray`` of the JAX package's
``LSH.rotations`` / ``LSH.planes``, and the fields of a ``StoreExport``), so
this module needs neither package's imports beyond the port's own.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from .core.lsh import LSH, LSHParams
from .core.reuse_store import ReuseStore
from .device import DeviceLike


def lsh_from_arrays(params: LSHParams, rotations: Optional[np.ndarray] = None,
                    planes: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> LSH:
    """The port's ``LSH`` with the given (T, K, D, D) rotations or (T, bits,
    D) planes instead of its own seeded draw."""
    return LSH(params, device, rotations=rotations, planes=planes)


def store_from_export(params: LSHParams, ids: Sequence[int], embeddings: np.ndarray,
                      results: Sequence[Any], buckets: np.ndarray, *, capacity: int,
                      device: DeviceLike = None) -> ReuseStore:
    """A port ``ReuseStore`` holding a ``StoreExport``'s entries.

    The entries land through ``insert_batch(..., buckets=)``, so they keep
    their admission-time table placement; ``ids`` are the source slot ids
    (informational: the store allocates its own, in the export's order).
    """
    n = len(ids)
    if not (len(embeddings) == len(results) == len(buckets) == n):
        raise ValueError("ids, embeddings, results and buckets differ in length")
    store = ReuseStore(params, capacity=capacity, device=device)
    if n:
        store.insert_batch(np.asarray(embeddings, np.float32), list(results),
                           buckets=np.asarray(buckets))
    return store
