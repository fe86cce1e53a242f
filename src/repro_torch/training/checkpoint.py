"""Fault-tolerant checkpointing: sharded, integrity-checked, async.

Port of ``repro/training/checkpoint.py``, in the reference's format: a
directory ``step_NNNNNNNN`` per step, holding

  * ``manifest.json``: every leaf's name (its dict keys joined with ``/``),
    shape, dtype, shard, offset, bytes and crc32, and every shard's file,
    raw bytes, codec and crc32;
  * ``shard-NNN.bin.zst`` (zstd, when ``zstandard`` imports) or
    ``shard-NNN.bin.zlib`` (the stdlib fallback): leaf payloads
    concatenated in name order, a new shard once ``SHARD_BYTES`` is passed.

Writes go to ``step_NNNNNNNN.tmp`` and are published by an atomic rename;
the newest ``keep`` checkpoints are kept.  Restore checks every shard's and
every leaf's crc32 before it installs anything.  Either package reads the
other's checkpoints (the leaf names differ: the reference stacks a layer
group's leaves, ``convert.train_state_from_jax`` maps them).

Trees are nested dicts of tensors (or numpy arrays).  A bfloat16 leaf
(``moment_dtype="bfloat16"``) is written as its raw bytes under the dtype
``"bfloat16"``, as the reference's ml_dtypes arrays are, and read back
through an int16 view, so neither side needs ml_dtypes.  ``restore``
copies into the leaves of the tree it is given, in place (one copy of the
training state).  ``AsyncCheckpointer.save`` snapshots a copy on the host
before it returns, so a step that then updates the state in place does not
change what is written.

Under a mesh the leaves are DTensors: a snapshot gathers each one's whole
value (a collective: every rank calls ``save``; rank 0 writes), and
``restore(..., shardings=)`` places every restored leaf with the given
placements, as the reference's ``restore`` places its leaves with
``NamedSharding``s.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib compression
    zstandard = None

SHARD_BYTES = 256 * 1024 * 1024


def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) in sorted key order (the reference's tree order)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _host(x) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        # torch's dtype names are numpy's ("float32", "int8", ...) and ml_dtypes'
        return str(t.dtype).removeprefix("torch."), list(t.shape), raw.numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(x))
    return str(a.dtype), list(a.shape), a.tobytes()


def _from_bytes(raw: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy()).reshape(shape)


def save(tree: Mapping, directory: str, step: int, keep: int = 3) -> str:
    """Synchronous checkpoint write; returns the checkpoint path."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": []}
    buf: List[bytes] = []

    def flush():
        if not buf:
            return
        raw = b"".join(buf)
        if zstandard is not None:
            comp, codec = zstandard.ZstdCompressor(level=3).compress(raw), "zst"
        else:
            comp, codec = zlib.compress(raw, 6), "zlib"
        fname = f"shard-{len(manifest['shards']):03d}.bin.{codec}"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(comp)
        manifest["shards"].append({"file": fname, "raw_bytes": len(raw), "codec": codec,
                                   "crc": zlib.crc32(raw) & 0xFFFFFFFF})
        buf.clear()

    size_in_shard = 0
    for name, leaf in _flatten(tree):
        dtype, shape, payload = _host(leaf)
        manifest["leaves"].append({
            "name": name, "shape": shape, "dtype": dtype, "shard": len(manifest["shards"]),
            "offset": size_in_shard, "bytes": len(payload),
            "crc": zlib.crc32(payload) & 0xFFFFFFFF,
        })
        buf.append(payload)
        size_in_shard += len(payload)
        if size_in_shard >= SHARD_BYTES:
            flush()
            size_in_shard = 0
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)  # atomic publish
    _gc(directory, keep)
    return ckpt


def _snapshot(tree: Mapping):
    """A host copy of every leaf (a CPU tensor's ``.cpu()`` is itself; a
    DTensor's whole value)."""
    return {k: _snapshot(v) if isinstance(v, Mapping)
            else _whole(v.detach()).to("cpu", copy=True) if isinstance(v, torch.Tensor)
            else np.array(v, copy=True) for k, v in tree.items()}


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no process group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree: Mapping, directory: str, step: int, keep: int = 3) -> None:
        host_tree = _snapshot(tree)
        self.wait()
        if not _writer():
            return
        self._thread = threading.Thread(
            target=self._write, args=(host_tree, directory, step, keep), daemon=True)
        self._thread.start()

    def _write(self, tree, directory, step, keep):
        self.last_path = save(tree, directory, step, keep)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def read(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """A checkpoint (the latest without ``step``) as the nested dicts it was
    saved from, with CPU tensor leaves, after the shards' and leaves' crc32
    checks.  A reference checkpoint reads as the reference's tree
    (``convert.train_state_from_jax`` takes it)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    shards: Dict[int, bytes] = {}
    for i, sh in enumerate(manifest["shards"]):
        with open(os.path.join(ckpt, sh["file"]), "rb") as f:
            blob = f.read()
        if sh.get("codec", "zst") == "zst":
            if zstandard is None:
                raise ImportError(
                    "checkpoint was written with zstandard, which is not installed")
            raw = zstandard.ZstdDecompressor().decompress(blob, max_output_size=sh["raw_bytes"])
        else:
            raw = zlib.decompress(blob)
        if (zlib.crc32(raw) & 0xFFFFFFFF) != sh["crc"]:
            raise OSError(f"checkpoint shard {sh['file']} failed integrity check")
        shards[i] = raw
    tree: Dict[str, Any] = {}
    for leaf in manifest["leaves"]:
        raw = shards[leaf["shard"]][leaf["offset"]: leaf["offset"] + leaf["bytes"]]
        if (zlib.crc32(raw) & 0xFFFFFFFF) != leaf["crc"]:
            raise OSError(f"leaf {leaf['name']} failed integrity check")
        *path, last = leaf["name"].split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = _from_bytes(raw, leaf["dtype"], leaf["shape"])
    return tree


def restore(directory: str, target_tree: Mapping, step: Optional[int] = None,
            shardings: Optional[Mapping] = None) -> Mapping:
    """Copy a checkpoint (the latest without ``step``) into the tensors of
    ``target_tree``, in place, and return the tree.  Every target leaf must
    be in the checkpoint with its shape and dtype.  ``shardings``: a tree
    of placements keyed like ``target_tree`` (``launch.shardings.
    state_shardings``); each leaf is then restored as a DTensor with its
    placements, on the target DTensor's mesh or else the active mesh
    (``models.partitioning.use_mesh``): in place when the target already is
    such a DTensor, as a new leaf of the tree otherwise."""
    by_name = dict(_flatten(read(directory, step)))
    want = dict(_flatten(shardings)) if shardings is not None else {}
    staged = []
    for name, ref in _flatten(target_tree):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        value = by_name[name]
        if list(value.shape) != list(ref.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != expected {tuple(ref.shape)}")
        if value.dtype != ref.dtype:
            raise ValueError(f"{name}: dtype {value.dtype} != expected {ref.dtype}")
        if name in want:
            value = _placed(name, value, ref, tuple(want[name]))
        staged.append((name, ref, value))
    with torch.no_grad():
        for name, ref, value in staged:
            if _same_layout(ref, value):
                ref.copy_(value)
            else:   # a plain target, or one of other placements: the new DTensor
                *path, last = name.split("/")
                node = target_tree
                for key in path:
                    node = node[key]
                node[last] = value
    return target_tree


def _placed(name: str, value: torch.Tensor, ref, placements):
    """``value`` as a DTensor with ``placements`` on ``ref``'s mesh (a
    DTensor's) or the active mesh; every rank read the whole value."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ..models.partitioning import get_mesh

    mesh = ref.device_mesh if isinstance(ref, DTensor) else get_mesh()
    if mesh is None:
        raise ValueError(f"{name}: placements given, but no mesh (use_mesh) is active")
    return distribute_tensor(value.to(mesh.device_type), mesh, placements, src_data_rank=None)


def _same_layout(ref, value) -> bool:
    """Whether ``value`` copies into ``ref`` as it is: both plain, or both
    DTensors with the same placements."""
    from torch.distributed.tensor import DTensor

    if isinstance(ref, DTensor) or isinstance(value, DTensor):
        return (isinstance(ref, DTensor) and isinstance(value, DTensor)
                and tuple(ref.placements) == tuple(value.placements))
    return True


def _gc(directory: str, keep: int) -> None:
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def resume_or_init(directory: str, init_fn):
    """Checkpoint/restart entry point -> (state, step): ``init_fn()``, and
    the latest checkpoint restored into it if there is one (step 0 if not)."""
    state = init_fn()
    step = latest_step(directory)
    if step is None:
        return state, 0
    return restore(directory, state, step), step
