"""Counter families with dict compatibility (own copy of ``repro.obs.registry``).

The port keeps only what its ported modules use: ``CounterGroup``, the home
of the serving engine's ``stats``.  Reads (``group["cs"]``, ``dict(group)``,
``group == {...}``) behave like the dict it replaces; code mutates through
``inc`` (lint rule O001 flags ``stats[...] += 1`` in sim paths).
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import Dict, Iterator, Optional


class CounterGroup(MutableMapping):
    """A named family of integer counters with dict compatibility."""

    __slots__ = ("_d",)

    def __init__(self, initial: Optional[Dict[str, int]] = None):
        self._d: Dict[str, int] = dict(initial or {})

    def inc(self, key: str, n: int = 1) -> None:
        self._d[key] = self._d.get(key, 0) + n

    # --- MutableMapping interface
    def __getitem__(self, key: str) -> int:
        return self._d[key]

    def __setitem__(self, key: str, value: int) -> None:
        self._d[key] = value

    def __delitem__(self, key: str) -> None:
        del self._d[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"CounterGroup({self._d!r})"
