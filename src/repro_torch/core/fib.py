"""Forwarding Information Base (FIB): longest-prefix match on name components."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .namespace import name_components


class FIB:
    def __init__(self):
        # prefix tuple -> ordered list of (face, cost)
        self._table: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
        self.lookups = 0

    def __len__(self) -> int:
        return len(self._table)

    def insert(self, prefix: str, face: int, cost: int = 0) -> None:
        key = tuple(name_components(prefix))
        routes = self._table.setdefault(key, [])
        routes[:] = [(f, c) for f, c in routes if f != face] + [(face, cost)]
        routes.sort(key=lambda fc: fc[1])

    def remove(self, prefix: str, face: Optional[int] = None) -> None:
        key = tuple(name_components(prefix))
        if face is None:
            self._table.pop(key, None)
            return
        routes = self._table.get(key)
        if routes is not None:
            routes[:] = [(f, c) for f, c in routes if f != face]
            if not routes:
                del self._table[key]

    def lookup(self, name: str) -> Optional[List[Tuple[int, int]]]:
        """Longest-prefix match; returns (face, cost) list or None."""
        self.lookups += 1
        comps = tuple(name_components(name))
        for n in range(len(comps), 0, -1):
            routes = self._table.get(comps[:n])
            if routes:
                return list(routes)
        routes = self._table.get(())
        return list(routes) if routes else None

    def next_hop(self, name: str) -> Optional[int]:
        routes = self.lookup(name)
        return routes[0][0] if routes else None
