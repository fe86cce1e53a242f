"""Request batcher: deadline-aware micro-batching for the serve path.

Port of ``repro/serving/batcher.py`` (pure Python, identical behaviour).

Groups compatible requests into model-sized batches per queue key — plain
service name on the sync path, ``(replica, service)`` on the async engine's
per-replica queues.  Flush triggers on size, on the head-of-queue wait
exceeding ``max_wait_s``, or on *deadline inheritance*: a queue inherits the
tightest ``ServeRequest.deadline_s`` of its members and flushes early enough
to leave at least half the deadline budget for execution.  The paper's TTC
estimates (§IV-C) provide the per-service latency model the deadlines are
set against.

``due_at`` exposes the earliest time a queue becomes due so an event-driven
caller (``serving/async_engine.py``) can schedule one flush timer per queue
instead of polling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional

from .engine import ServeRequest


@dataclasses.dataclass
class PendingEntry:
    req: ServeRequest
    arrival_s: float


class Batcher:
    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.005):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.queues: Dict[Hashable, List[PendingEntry]] = {}
        self.flushes = 0
        self.batched_total = 0

    def add(self, req: ServeRequest, now: float,
            key: Optional[Hashable] = None) -> Optional[List[ServeRequest]]:
        key = req.service if key is None else key
        q = self.queues.setdefault(key, [])
        q.append(PendingEntry(req, now))
        if len(q) >= self.max_batch:
            return self.flush(key, now)
        return None

    def pending(self, key: Hashable) -> int:
        return len(self.queues.get(key, ()))

    def due(self, key: Hashable, now: float) -> bool:
        t = self.due_at(key)
        return t is not None and now >= t

    def due_at(self, key: Hashable) -> Optional[float]:
        """Earliest time the queue becomes due (None when empty).

        min of head-arrival + max_wait and, per deadline-carrying entry, the
        inherited flush point ``arrival + deadline/2 - max_wait`` (leave half
        the budget for execution), clamped to the entry's arrival time.
        """
        q = self.queues.get(key, [])
        if not q:
            return None
        t = q[0].arrival_s + self.max_wait_s
        for e in q:
            if e.req.deadline_s is not None:
                t = min(t, max(e.arrival_s,
                               e.arrival_s + e.req.deadline_s * 0.5
                               - self.max_wait_s))
        return t

    def flush(self, key: Hashable, now: float) -> List[ServeRequest]:
        q = self.queues.get(key, [])
        batch, rest = q[: self.max_batch], q[self.max_batch:]
        if rest:
            self.queues[key] = rest
        else:
            self.queues.pop(key, None)
        self.flushes += 1
        self.batched_total += len(batch)
        return [e.req for e in batch]

    def flush_due(self, now: float) -> Dict[Hashable, List[ServeRequest]]:
        out = {}
        for key in list(self.queues):
            if self.due(key, now):
                out[key] = self.flush(key, now)
        return out
