"""Pending Interest Table (PIT) with aggregation (paper §II).

Simultaneously offloaded similar tasks share a name, so all but the first are
*aggregated*: they leave state but are not forwarded; one Data satisfies all.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .packets import Interest


@dataclasses.dataclass
class PitEntry:
    name: str
    in_faces: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # (face, nonce)
    expiry: float = 0.0


class PendingInterestTable:
    def __init__(self, lifetime_s: float = 4.0):
        self.lifetime_s = lifetime_s
        self._table: Dict[str, PitEntry] = {}
        self.aggregations = 0
        self.retransmits = 0
        self.duplicates = 0

    def __len__(self) -> int:
        return len(self._table)

    def admit(self, interest: Interest, in_face: int, now: float) -> str:
        """Classify an incoming Interest against pending state.

        Returns one of:

        * ``"new"``         — no live entry; one was created, forward it.
        * ``"aggregate"``   — joins a live entry; do not forward, the
                              pending upstream exchange will satisfy it.
        * ``"retransmit"``  — consumer re-expression (``interest.retx``) of
                              a still-pending name: recorded on the entry
                              and the lifetime refreshed, but the caller
                              must forward it upstream — the first copy may
                              have been lost on a link.
        * ``"duplicate"``   — exact (face, nonce) already seen; drop (the
                              NDN nonce loop/duplicate check).
        """
        entry = self._table.get(interest.name)
        if entry is not None and now <= entry.expiry:
            if (in_face, interest.nonce) in entry.in_faces:
                self.duplicates += 1
                return "duplicate"
            entry.in_faces.append((in_face, interest.nonce))
            entry.expiry = now + self.lifetime_s
            if interest.retx:
                self.retransmits += 1
                return "retransmit"
            self.aggregations += 1
            return "aggregate"
        self._table[interest.name] = PitEntry(
            interest.name, [(in_face, interest.nonce)], now + self.lifetime_s
        )
        return "new"

    def insert(self, interest: Interest, in_face: int, now: float) -> bool:
        """Returns True if this is a NEW entry (Interest must be forwarded);
        False if aggregated with an existing pending entry."""
        return self.admit(interest, in_face, now) == "new"

    def satisfy(self, name: str) -> Optional[List[int]]:
        """Data arrived: pop the entry, return downstream faces to send to."""
        entry = self._table.pop(name, None)
        if entry is None:
            return None
        faces: List[int] = []
        for face, _ in entry.in_faces:
            if face not in faces:
                faces.append(face)
        return faces

    def expire(self, now: float) -> int:
        stale = [n for n, e in self._table.items() if now > e.expiry]
        for n in stale:
            del self._table[n]
        return len(stale)
