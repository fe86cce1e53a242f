"""Content Store (CS): the NDN in-network result cache (paper §II, §IV-B).

Because similar tasks share a name (LSH), a CS hit on a task name *is*
computation reuse in the network — the paper's 12–21× completion-time win.
LRU replacement matches the paper's §V-C cache-size study.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from .packets import Data


class ContentStore:
    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._store: "OrderedDict[str, tuple[float, Data]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def insert(self, data: Data, now: float = 0.0) -> None:
        if self.capacity <= 0:
            return
        if data.name in self._store:
            self._store.pop(data.name)
        self._store[data.name] = (now + data.freshness_s, data)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)  # LRU
            self.evictions += 1

    def lookup(self, name: str, now: float = 0.0) -> Optional[Data]:
        entry = self._store.get(name)
        if entry is None:
            self.misses += 1
            return None
        expires, data = entry
        if now > expires:
            del self._store[name]
            self.misses += 1
            return None
        self._store.move_to_end(name)  # refresh LRU position
        self.hits += 1
        return data

    def clear(self) -> None:
        self._store.clear()
