"""Task namespace design (paper §IV-B).

A task is an Interest named ``/<service>/task/<hash-of-input>``.  When a
family of LSH tables is used, the per-table bucket indices are concatenated —
each padded to the rFIB-advertised ``index_size_bytes`` — and hex-encoded as
the third name component.  The paper's example ``/OpenPose/task/6E810F`` is
three 1-byte table indices (0x6E, 0x81, 0x0F); forwarders split the component
back into per-table indices using the index size stored in the rFIB (Fig. 4).

Tasks that opt out of reuse (paper §IV-E, "tasks with minor similarities")
instead use ``/<service>/exact/<digest>`` with a cheap exact hash (CRC32-like)
so forwarders skip the rFIB entirely.
"""
from __future__ import annotations

import zlib
from typing import List, Sequence

TASK_KEYWORD = "task"
EXACT_KEYWORD = "exact"


def encode_task_hash(buckets: Sequence[int], index_size_bytes: int) -> str:
    """Concatenate per-table bucket indices into the name's hash component."""
    out = bytearray()
    for b in buckets:
        b = int(b)
        if b < 0 or b >= 256**index_size_bytes:
            raise ValueError(f"bucket {b} does not fit in {index_size_bytes} byte(s)")
        out += b.to_bytes(index_size_bytes, "big")
    return out.hex().upper()


def decode_task_hash(component: str, index_size_bytes: int) -> List[int]:
    raw = bytes.fromhex(component)
    if len(raw) % index_size_bytes:
        raise ValueError("hash component length inconsistent with index size")
    n = index_size_bytes
    return [int.from_bytes(raw[i : i + n], "big") for i in range(0, len(raw), n)]


def make_task_name(service: str, buckets: Sequence[int], index_size_bytes: int) -> str:
    service = service.strip("/")
    return f"/{service}/{TASK_KEYWORD}/{encode_task_hash(buckets, index_size_bytes)}"


def make_exact_name(service: str, payload: bytes) -> str:
    """Opt-out path: cheap non-LSH digest (paper §IV-E uses e.g. CRC32/SHA1)."""
    service = service.strip("/")
    return f"/{service}/{EXACT_KEYWORD}/{zlib.crc32(payload):08X}"


def name_components(name: str) -> List[str]:
    return [c for c in name.split("/") if c]


def is_task_name(name: str) -> bool:
    """Forwarder check (Fig. 5): is the second-to-last component 'task'?

    Plain tasks are ``/<svc>/task/<hash>``; result-fetch Interests after a TTC
    exchange are ``/<EN-prefix>/<svc>/task/<hash>`` (paper §IV-C) — those carry
    an explicit destination prefix and are forwarded via plain FIB, so only
    3-component names count as rFIB-eligible tasks.
    """
    comps = name_components(name)
    return len(comps) == 3 and comps[1] == TASK_KEYWORD


def parse_task_name(name: str):
    comps = name_components(name)
    if len(comps) < 3 or comps[-2] not in (TASK_KEYWORD, EXACT_KEYWORD):
        raise ValueError(f"not a task name: {name!r}")
    return "/" + "/".join(comps[:-2]), comps[-2], comps[-1]
