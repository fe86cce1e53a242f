"""Locality-Sensitive Hashing for Reservoir (paper §II, §IV), in PyTorch.

Port of ``repro/core/lsh.py``.  Two families, as in FALCONN [7]:

* ``cross_polytope``: project the unit-normalised input through K dense
  random rotations per table; one rotation's hash is the closest
  cross-polytope vertex, the first maximum of ``concat([proj, -proj])``.
* ``hyperplane``: sign random projection; ``bits`` planes per table give a
  ``2**bits``-bucket table.

Rotations and planes are sampled with the reference's numpy code
(``default_rng(seed)`` + ``_orthogonalize``) and only then become tensors, so
they are bitwise identical to the JAX package's.  Multi-probe and the
hyperplane hash are plain torch, as the JAX package leaves them to XLA, with
their matmuls held at full fp32 (``device.fp32_matmul``) whatever the
process's TF32 setting, so probe 0 is the kernel's hash.
``jax.lax.top_k`` and ``jnp.argmax`` put the lower index first on a tie;
``torch.topk`` promises no order among ties, so ranking here goes through a
stable descending sort.

On a CUDA device the cross-polytope ``hash_batch`` runs the hand-written
``lsh_hash_mix`` kernel (``kernels/lsh_hash.py``); on a CPU device it runs
that kernel's plain version, the same function.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, fp32_matmul, resolve_device
from ..kernels import lsh_hash as _lsh_kernels


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Static configuration of an LSH family (field for field the reference's).

    ``num_buckets`` is per-table; the paper's rFIB stores the per-table index
    size in bytes (Fig. 4), so ``index_size_bytes`` must satisfy
    ``num_buckets <= 256 ** index_size_bytes`` (FALCONN max: 4 bytes).
    """

    dim: int
    num_tables: int = 5
    rotations_per_table: int = 1
    num_buckets: int = 256
    num_probes: int = 8
    family: str = "cross_polytope"  # or "hyperplane"
    seed: int = 0

    @property
    def index_size_bytes(self) -> int:
        n, size = self.num_buckets - 1, 1
        while n >= 256:
            n >>= 8
            size += 1
        if size > 4:
            raise ValueError("FALCONN supports at most 4-byte bucket indices")
        return size

    @property
    def bits(self) -> int:
        """Hyperplane family: planes per table (log2 of buckets)."""
        b = int(np.log2(self.num_buckets))
        if 2 ** b != self.num_buckets:
            raise ValueError("hyperplane family needs power-of-two num_buckets")
        return b

    @property
    def effective_buckets(self) -> int:
        """Number of bucket indices that can actually occur (see reference)."""
        if self.family == "cross_polytope":
            return min(self.num_buckets, (2 * self.dim) ** self.rotations_per_table)
        return self.num_buckets


def _orthogonalize(m: np.ndarray) -> np.ndarray:
    q, r = np.linalg.qr(m)
    return (q * np.sign(np.diag(r))).astype(np.float32)


def sample_params(params: LSHParams) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(rotations (T, K, D, D) | None, planes (T, bits, D) | None) as numpy,
    drawn exactly as ``repro.core.lsh.LSH.__init__`` draws them."""
    rng = np.random.default_rng(params.seed)
    d, t, k = params.dim, params.num_tables, params.rotations_per_table
    if params.family == "cross_polytope":
        rots = rng.standard_normal((t, k, d, d)).astype(np.float32)
        rots = np.stack(
            [np.stack([_orthogonalize(rots[i, j]) for j in range(k)]) for i in range(t)]
        )
        return rots, None
    if params.family == "hyperplane":
        planes = rng.standard_normal((t, params.bits, d)).astype(np.float32)
        return None, planes / np.linalg.norm(planes, axis=-1, keepdims=True)
    raise ValueError(f"unknown LSH family {params.family!r}")


# ---------------------------------------------------------------------------
# Pure hash/probe math, shared by LSH and the fused query pipeline
# (kernels/fused_query.py), so both probe bit-identically.
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` semantics: descending, lower index first on a tie."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def mix_vertex_ids(vids: torch.Tensor, radix: int, num_buckets: int) -> torch.Tensor:
    """Fold K per-rotation vertex ids (..., K) into one bucket id (...,), in
    int32 as the reference does (num_buckets * radix stays below 2**31)."""
    val = torch.zeros(vids.shape[:-1], dtype=torch.int32, device=vids.device)
    for k in range(vids.shape[-1]):
        val = (val * radix + vids[..., k].to(torch.int32)) % num_buckets
    return val


def cp_vertex_scores(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Cross-polytope vertex scores: (B, T, K, 2D); vertex v<D is +e_v."""
    with fp32_matmul():
        proj = torch.einsum("tkde,be->btkd", rotations, x)
    return torch.cat([proj, -proj], dim=-1)


@functools.lru_cache(maxsize=64)
def _int32_const(values: Tuple[int, ...], device: str) -> torch.Tensor:
    """Small int32 constants on a device, copied there once: a host-to-device
    copy waits for the device, and the fused query reads nothing back."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def multiprobe_buckets(
    x: torch.Tensor,
    proj: torch.Tensor,
    *,
    family: str,
    dim: int,
    rotations_per_table: int,
    num_probes: int,
    num_buckets: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranked multi-probe buckets: (B, T, P) int32 ids + (B, T, P) losses.

    ``proj`` is ``(T, K, D, D)`` rotations (cross-polytope) or ``(T, bits,
    D)`` unit planes (hyperplane).  Mirrors ``repro.core.lsh.multiprobe_buckets``
    step for step.
    """
    x = x.to(torch.float32)
    dev = x.device
    if family == "cross_polytope":
        scores = cp_vertex_scores(x, proj)  # (B,T,K,2D)
        k = rotations_per_table
        m = min(max(2, num_probes // max(k, 1) + 1), 2 * dim)
        top_v, top_i = top_k(scores, m)  # (B,T,K,m)
        base_ids = top_i[..., 0]  # (B,T,K)
        radix = 2 * dim
        base_bucket = mix_vertex_ids(base_ids, radix, num_buckets)  # (B,T)
        w = _int32_const(tuple(pow(radix, k - 1 - i, num_buckets) for i in range(k)),
                         str(dev))
        alt_loss = top_v[..., :1] - top_v  # (B,T,K,m)
        delta = (top_i - base_ids[..., None]) % num_buckets
        cand = (base_bucket[..., None, None] + delta * w[:, None]) % num_buckets
        flat_loss = alt_loss[..., 1:].reshape(*alt_loss.shape[:2], -1)
        flat_cand = cand[..., 1:].reshape(*cand.shape[:2], -1)
        nprob = min(num_probes - 1, flat_loss.shape[-1])
        neg_loss, order = top_k(-flat_loss, nprob)
        picked = torch.gather(flat_cand, -1, order.long())
        buckets = torch.cat([base_bucket[..., None], picked], dim=-1)
        losses = torch.cat(
            [torch.zeros_like(base_bucket, dtype=torch.float32)[..., None], -neg_loss],
            dim=-1)
        return buckets.to(torch.int32), losses
    # hyperplane: flip bits ranked by |margin|
    with fp32_matmul():
        margins = torch.einsum("tbd,nd->ntb", proj, x)  # (B,T,bits)
    bits = (margins > 0).to(torch.int32)
    base_bucket = mix_vertex_ids(bits, 2, num_buckets)
    nbits = margins.shape[-1]
    w = _int32_const(tuple(1 << (nbits - 1 - i) for i in range(nbits)), str(dev))
    flipped = torch.bitwise_xor(base_bucket[..., None], w) % num_buckets
    loss = margins.abs()
    nprob = min(num_probes - 1, nbits)
    neg_loss, order = top_k(-loss, nprob)
    picked = torch.gather(flipped, -1, order.long())
    buckets = torch.cat([base_bucket[..., None], picked], dim=-1)
    losses = torch.cat(
        [torch.zeros_like(base_bucket, dtype=torch.float32)[..., None], -neg_loss], dim=-1)
    return buckets.to(torch.int32), losses


class LSH:
    """An instantiated LSH family on one device: parameters + hash/probe ops.

    ``rotations``/``planes`` default to the seeded draw of ``params``;
    ``convert.lsh_from_arrays`` passes the JAX package's arrays instead.
    """

    def __init__(self, params: LSHParams, device: DeviceLike = None, *,
                 rotations: Optional[np.ndarray] = None,
                 planes: Optional[np.ndarray] = None):
        self.params = params
        self.device = resolve_device(device)
        if rotations is None and planes is None:
            rotations, planes = sample_params(params)
        d, t = params.dim, params.num_tables
        if params.family == "cross_polytope":
            want = (t, params.rotations_per_table, d, d)
            if rotations is None or tuple(rotations.shape) != want:
                raise ValueError(f"cross-polytope rotations must have shape {want}")
            self.rotations = torch.tensor(
                np.asarray(rotations, np.float32), device=self.device)
            self.planes = None
        elif params.family == "hyperplane":
            want = (t, params.bits, d)
            if planes is None or tuple(planes.shape) != want:
                raise ValueError(f"hyperplane planes must have shape {want}")
            self.rotations = None
            self.planes = torch.tensor(
                np.asarray(planes, np.float32), device=self.device)
        else:
            raise ValueError(f"unknown LSH family {params.family!r}")

    def _input(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return torch.atleast_2d(x.to(self.device, torch.float32)).contiguous()

    # ------------------------------------------------------------------ hash
    def hash_batch(self, x) -> torch.Tensor:
        """(B, D) -> (B, T) int32 bucket ids in [0, num_buckets), on the
        LSH's device."""
        p = self.params
        x = self._input(x)
        if p.family == "cross_polytope":
            return _lsh_kernels.lsh_hash_mix(x, self.rotations, p.num_buckets)
        with fp32_matmul():
            margins = torch.einsum("tbd,nd->ntb", self.planes, x)  # (B,T,bits)
        return mix_vertex_ids((margins > 0).to(torch.int32), 2, p.num_buckets)

    # ----------------------------------------------------------------- probe
    def probe_scores(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ranked multi-probe buckets: (B, T, P) ids + (B, T, P) losses."""
        p = self.params
        proj = self.rotations if p.family == "cross_polytope" else self.planes
        return multiprobe_buckets(
            self._input(x), proj, family=p.family, dim=p.dim,
            rotations_per_table=p.rotations_per_table,
            num_probes=p.num_probes, num_buckets=p.num_buckets)

    def probe_batch(self, x) -> torch.Tensor:
        """(B, D) -> (B, T, P) ranked probe bucket ids (probe 0 == hash)."""
        return self.probe_scores(x)[0]

    # ------------------------------------------------------------- utilities
    def hash_one(self, x) -> np.ndarray:
        return self.hash_batch(self._input(x).reshape(1, -1)).cpu().numpy()[0]

    def probe_one(self, x) -> np.ndarray:
        return self.probe_batch(self._input(x).reshape(1, -1)).cpu().numpy()[0]


@functools.lru_cache(maxsize=32)
def _cached_lsh(params: LSHParams, device: str) -> LSH:
    return LSH(params, device)


def get_lsh(params: LSHParams, device: DeviceLike = None) -> LSH:
    """Cached LSH instances, keyed on ``(params, device)``."""
    return _cached_lsh(params, str(resolve_device(device)))


def normalize(x: np.ndarray) -> np.ndarray:
    """L2-normalise rows (cross-polytope LSH operates on the unit sphere)."""
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)
