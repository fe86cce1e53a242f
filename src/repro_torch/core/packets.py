"""NDN packet abstractions used by Reservoir (semantics, not wire format).

We keep the *state-machine semantics* of NDN Interests/Data (names, PIT
aggregation by name, CS caching by name, forwarding hints, application
parameters) and model signatures as a content checksum; the TLV wire encoding
is out of scope (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Any, Dict, Optional

_nonce = itertools.count(1)


@dataclasses.dataclass
class Interest:
    """An NDN Interest.  Tasks carry Reservoir fields in app_params (§IV-B):

    - ``deadline``: max tolerable latency (seconds)
    - ``threshold``: similarity threshold for reuse
    - ``input``: task input embedding (small inputs ride in the Interest)
    - ``input_size``: estimated input size (bytes) for the pull path (§IV-C)
    - ``user_prefix``: requester prefix for direct communication (§IV-C)

    ``retx`` is the consumer's retry counter (0 = first transmission).  A
    retransmission carries a *fresh* nonce — exact (face, nonce) duplicates
    are dropped at the PIT — but the flag lets forwarders distinguish a
    deliberate re-expression (forward it upstream, the first copy may be
    lost) from an independent same-name request (aggregate it).
    """

    name: str
    app_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    forwarding_hint: Optional[str] = None  # attached after the one rFIB lookup
    nonce: int = dataclasses.field(default_factory=lambda: next(_nonce))
    hop_limit: int = 64
    retx: int = 0

    def copy(self) -> "Interest":
        return dataclasses.replace(self, app_params=dict(self.app_params))


@dataclasses.dataclass
class Data:
    """An NDN Data packet; ``signature`` models producer signing at rest."""

    name: str
    content: Any = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    freshness_s: float = 60.0
    signature: int = 0

    def __post_init__(self):
        if not self.signature:
            self.signature = zlib.crc32(repr(self.content).encode()) & 0xFFFFFFFF

    def verify(self) -> bool:
        return self.signature == zlib.crc32(repr(self.content).encode()) & 0xFFFFFFFF
