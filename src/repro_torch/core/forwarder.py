"""NDN forwarder with the Reservoir-extended Interest pipeline (paper Fig. 5).

Pipeline on Interest arrival:
  1. CS lookup — cached Data with the same (LSH) name satisfies the Interest
     immediately: *reuse in the network*.
  2. PIT insert — an identical pending name aggregates (not forwarded).
  3. If the Interest carries a forwarding hint (rFIB already consulted
     upstream) or is not a task: plain FIB longest-prefix forwarding.
  4. Else if it is a task (``/<svc>/task/<hash>``): one rFIB lookup picks the
     EN handling the majority of the indexed buckets, attaches its prefix as
     the forwarding hint, and forwards on the matched interface.

Data path: verify, satisfy PIT, cache in CS, fan out to downstream faces.

The forwarder is simulator-agnostic: ``on_interest``/``on_data`` return
``ForwardAction``s (face, packet, processing delay) that the owner (the
discrete-event network in ``network.py`` or a unit test) executes.  Processing
delays default to the paper's measured values (§V-C): 71–101 µs for FIB
forwarding, 74–106 µs for the rFIB path, <5 µs extra for the one rFIB lookup.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Union

from .content_store import ContentStore
from .fib import FIB
from .namespace import is_task_name, name_components, parse_task_name
from .packets import Data, Interest
from .pit import PendingInterestTable
from .rfib import RFIB


@dataclasses.dataclass
class ForwardAction:
    face: int
    packet: Union[Interest, Data]
    delay_s: float  # node processing delay to charge before emission


@dataclasses.dataclass
class ForwarderStats:
    interests: int = 0
    data: int = 0
    cs_hits: int = 0
    aggregated: int = 0
    rfib_routed: int = 0
    fib_routed: int = 0
    dropped: int = 0
    retx_forwarded: int = 0
    nonce_duplicates: int = 0
    pit_expired: int = 0


class Forwarder:
    def __init__(
        self,
        node_id: str,
        cs_capacity: int = 256,
        fib_delay_range=(71e-6, 101e-6),
        rfib_delay_range=(74e-6, 106e-6),
        seed: int = 0,
        pit_lifetime_s: float = 4.0,
    ):
        self.node_id = node_id
        self.cs = ContentStore(cs_capacity)
        self.pit = PendingInterestTable(lifetime_s=pit_lifetime_s)
        self.fib = FIB()
        self.rfib = RFIB()
        self.stats = ForwarderStats()
        self._fib_delay = fib_delay_range
        self._rfib_delay = rfib_delay_range
        self._rng = random.Random(seed)

    # ------------------------------------------------------------------ util
    def _delay(self, rng_range) -> float:
        lo, hi = rng_range
        return self._rng.uniform(lo, hi)

    # ------------------------------------------------------------- interests
    def on_interest(self, interest: Interest, in_face: int, now: float) -> List[ForwardAction]:
        self.stats.interests += 1
        # 1. Content Store: a hit on an LSH task name IS computation reuse.
        cached = self.cs.lookup(interest.name, now)
        if cached is not None:
            self.stats.cs_hits += 1
            meta = dict(cached.meta)
            meta["reuse"] = "cs"  # satisfied from this forwarder's CS
            meta["reuse_node"] = self.node_id
            hit = dataclasses.replace(cached, meta=meta)
            return [ForwardAction(in_face, hit, self._delay(self._fib_delay))]
        # 2. PIT admit: aggregate / dedup / pass retransmissions upstream.
        verdict = self.pit.admit(interest, in_face, now)
        if verdict == "aggregate":
            self.stats.aggregated += 1
            return []
        if verdict == "duplicate":
            self.stats.nonce_duplicates += 1
            return []
        if verdict == "retransmit":
            self.stats.retx_forwarded += 1  # falls through: forward upstream
        # 3./4. Forwarding decision.
        if interest.forwarding_hint is None and is_task_name(interest.name):
            service, _, hash_comp = parse_task_name(interest.name)
            entry = self.rfib.lookup(service, hash_comp)
            if entry is not None:
                fwd = interest.copy()
                fwd.forwarding_hint = entry.en_prefix
                fwd.hop_limit = interest.hop_limit - 1
                self.stats.rfib_routed += 1
                face = entry.faces[0] if entry.faces else self.fib.next_hop(entry.en_prefix)
                if face is None:
                    self.stats.dropped += 1
                    return []
                return [ForwardAction(face, fwd, self._delay(self._rfib_delay))]
            # No rFIB entry: fall through to FIB (service may be remote).
        lookup_name = interest.forwarding_hint or interest.name
        face = self.fib.next_hop(lookup_name)
        if face is None or interest.hop_limit <= 0:
            self.stats.dropped += 1
            return []
        fwd = interest.copy()
        fwd.hop_limit = interest.hop_limit - 1
        self.stats.fib_routed += 1
        return [ForwardAction(face, fwd, self._delay(self._fib_delay))]

    # ------------------------------------------------------------------ data
    def on_data(self, data: Data, in_face: int, now: float) -> List[ForwardAction]:
        self.stats.data += 1
        if not data.verify():
            self.stats.dropped += 1
            return []
        faces = self.pit.satisfy(data.name)
        if faces is None:
            self.stats.dropped += 1  # unsolicited
            return []
        if data.meta.get("cacheable", True):
            self.cs.insert(data, now)
        delay = self._delay(self._fib_delay)
        return [ForwardAction(f, data, delay) for f in faces if f != in_face or len(faces) == 1]

    # ---------------------------------------------------------- housekeeping
    def expire(self, now: float) -> int:
        n = self.pit.expire(now)
        self.stats.pit_expired += n
        return n
