"""Reuse FIB (rFIB) — the paper's core forwarder extension (§IV-D, Fig. 4).

Each entry maps a *service* plus a consecutive range of LSH bucket indices
(per table) to the EN that handles those buckets, its outgoing interface(s),
and the per-table index size in bytes.  Lookup decodes the per-table bucket
indices from the task name's hash component, finds the EN whose range covers
each table's index, and picks the EN handling the **majority** of the indexed
buckets (maximising the chance of reuse).  The lookup happens once per task;
the result is attached as the Interest's forwarding hint.

Consecutive ranges also serve as this framework's elastic-scaling unit: when
ENs join/leave, ranges are re-split (``partition``/``rebalance``), exactly the
consistent-range scheme described in DESIGN.md §4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .namespace import decode_task_hash


@dataclasses.dataclass
class RFibEntry:
    service: str
    # per-table inclusive bucket ranges: table index -> (lo, hi)
    ranges: Dict[int, Tuple[int, int]]
    en_prefix: str
    faces: List[int]
    index_size_bytes: int = 1

    def covers(self, table: int, bucket: int) -> bool:
        r = self.ranges.get(table)
        return r is not None and r[0] <= bucket <= r[1]

    def size_bytes(self) -> int:
        """On-forwarder footprint estimate (for the paper's rFIB-size study)."""
        return (
            len(self.service)
            + len(self.en_prefix)
            + len(self.ranges) * (1 + 2 * self.index_size_bytes)  # table id + lo/hi
            + len(self.faces) * 2
            + 1  # index size field
        )


class RFIB:
    def __init__(self):
        self._by_service: Dict[str, List[RFibEntry]] = {}
        self.lookups = 0

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_service.values())

    def insert(self, entry: RFibEntry) -> None:
        self._by_service.setdefault(entry.service.strip("/"), []).append(entry)

    def entries(self, service: str) -> List[RFibEntry]:
        return self._by_service.get(service.strip("/"), [])

    def index_size(self, service: str) -> Optional[int]:
        entries = self.entries(service)
        return entries[0].index_size_bytes if entries else None

    def size_bytes(self) -> int:
        return sum(e.size_bytes() for v in self._by_service.values() for e in v)

    def lookup(self, service: str, hash_component: str) -> Optional[RFibEntry]:
        """Majority vote over tables (paper Fig. 4 example: 2-of-3 -> EN1)."""
        self.lookups += 1
        entries = self.entries(service)
        if not entries:
            return None
        buckets = decode_task_hash(hash_component, entries[0].index_size_bytes)
        return majority_owner(entries, buckets)


def majority_owner(entries: Sequence[RFibEntry],
                   buckets: Sequence[int]) -> Optional[RFibEntry]:
    """The entry owning the majority of ``buckets`` (one per table).

    Shared between ``RFIB.lookup`` (task routing) and store migration
    (ownership of an admitted entry): both MUST agree, or a migrated entry
    lands on an EN the rFIB will never route its near-duplicates to.
    """
    votes: Dict[str, int] = {}
    first: Dict[str, RFibEntry] = {}
    for table, bucket in enumerate(buckets):
        for e in entries:
            if e.covers(table, int(bucket)):
                votes[e.en_prefix] = votes.get(e.en_prefix, 0) + 1
                first.setdefault(e.en_prefix, e)
                break
    if not votes:
        return None
    # majority; ties broken by EN prefix for determinism
    winner = max(votes.items(), key=lambda kv: (kv[1], kv[0]))[0]
    return first[winner]


def owners_batch(entries: Sequence[RFibEntry],
                 buckets: np.ndarray) -> List[Optional[str]]:
    """Vectorized ``majority_owner`` over an (N, T) bucket matrix.

    Returns the winning ``en_prefix`` per row (None where no entry covers
    any table's bucket).  Votes and tie-breaks match ``majority_owner``
    exactly — first covering entry per (table, bucket) gets the vote,
    winner is the (count, prefix) maximum — so a migration diff computed
    here can never disagree with ``RFIB.lookup`` routing.
    """
    buckets = np.atleast_2d(np.asarray(buckets, np.int64))
    n, t_n = buckets.shape
    if n == 0 or not entries:
        return [None] * n
    # prefix columns ordered DESCENDING so argmax's first-max tie-break
    # picks the lexicographically largest prefix, matching majority_owner
    prefixes = sorted({e.en_prefix for e in entries}, reverse=True)
    col = {p: i for i, p in enumerate(prefixes)}
    votes = np.zeros((n, len(prefixes)), np.int64)
    for t in range(t_n):
        b = buckets[:, t]
        taken = np.zeros(n, bool)  # first covering entry wins the table
        for e in entries:
            r = e.ranges.get(t)
            if r is None:
                continue
            m = ~taken & (b >= r[0]) & (b <= r[1])
            if m.any():
                votes[m, col[e.en_prefix]] += 1
                taken |= m
    win = np.argmax(votes, axis=1)
    has = votes.max(axis=1) > 0
    return [prefixes[w] if h else None for w, h in zip(win, has)]


def partition(
    service: str,
    en_prefixes: Sequence[str],
    faces: Dict[str, List[int]],
    num_tables: int,
    num_buckets: int,
    index_size_bytes: int = 1,
    weights: Optional[Sequence[float]] = None,
) -> List[RFibEntry]:
    """Equally (or weighted) distribute consecutive bucket ranges among ENs.

    Matches the paper's evaluation setup ("we equally distribute the LSH
    buckets between the ENs") and Fig. 4's consecutive-block layout.
    """
    n = len(en_prefixes)
    if n == 0:
        return []
    if weights is None:
        weights = [1.0] * n
    total = sum(weights)
    bounds = [0]
    acc = 0.0
    for w in weights:
        acc += w
        bounds.append(round(num_buckets * acc / total))
    bounds[-1] = num_buckets
    out = []
    for i, en in enumerate(en_prefixes):
        lo, hi = bounds[i], bounds[i + 1] - 1
        if hi < lo:
            continue
        out.append(
            RFibEntry(
                service=service.strip("/"),
                ranges={t: (lo, hi) for t in range(num_tables)},
                en_prefix=en,
                faces=list(faces.get(en, [])),
                index_size_bytes=index_size_bytes,
            )
        )
    return out


def rebalance(rfib: RFIB, service: str, en_prefixes: Sequence[str],
              faces: Dict[str, List[int]], num_tables: int, num_buckets: int,
              index_size_bytes: int = 1,
              weights: Optional[Sequence[float]] = None) -> None:
    """Elastic re-partition after EN join/leave: replace the service's entries.

    ``weights`` (federation layer): persistent load skew shifts bucket
    *ownership*, not just individual tasks — a hot EN gets a proportionally
    narrower consecutive range, so future arrivals route elsewhere while
    each bucket still has exactly one owner (reuse affinity is preserved).
    In-flight Interests routed via a replaced entry carry a now-dangling
    forwarding hint; the owner network fails them over to the new owner
    (``ReservoirNetwork._failover_interest``).
    """
    svc = service.strip("/")
    rfib._by_service[svc] = partition(
        svc, en_prefixes, faces, num_tables, num_buckets, index_size_bytes,
        weights=weights,
    )
