"""Chaos controller: executes a ``FaultPlan`` against a ``ReservoirNetwork``
(DESIGN.md §Fault model).

The controller attaches to the network's fault seam (``net.chaos``) and is
consulted at three points:

* ``on_link``      — every link traversal (``ReservoirNetwork._emit``):
                     returns None to drop the packet, else extra delay
                     (0.0 when no jitter rule matches);
* ``exec_factor``  — every sampled execution time (slow-node inflation);
* ``gossip_drop``  — every telemetry snapshot delivery
                     (``TelemetryGossip._apply``).

Crash events are scheduled on the shared event loop at attach time, so a
crash lands at its exact virtual time regardless of traffic.

Determinism: the controller draws from its OWN ``random.Random``, seeded via
crc32 (never the process-salted ``hash()``), and only draws when an *active*
rule actually matches — so an empty (or not-yet-active) plan consumes zero
randomness and perturbs neither the network's RNG stream nor its event
timing.  That is what makes the zero-fault parity golden
(tests/test_cosim.py) possible: chaos-with-empty-plan is bit-for-bit the
plain simulator.
"""
from __future__ import annotations

import random
import zlib
from typing import Any, Optional

from ..core.packets import Interest
from ..obs.registry import CounterGroup

from .plan import FaultPlan


class ChaosController:
    def __init__(self, net, plan: FaultPlan):
        self.net = net
        self.plan = plan
        # crc32-derived seed: deterministic across processes (never hash())
        self._rng = random.Random(zlib.crc32(b"reservoir-chaos")
                                  ^ (plan.seed & 0xFFFFFFFF))
        self.stats = CounterGroup({
            "interest_drops": 0,
            "data_drops": 0,
            "partition_drops": 0,
            "jitter_added": 0,
            "gossip_drops": 0,
            "slow_samples": 0,
            "crashes": 0,
        })
        net.chaos = self
        reg = getattr(net, "registry", None)
        if reg is not None:
            reg.adopt("chaos", self.stats)
        for ev in plan.crashes:
            net.loop.at(ev.at, self._crash, ev.node)

    def detach(self) -> None:
        if self.net.chaos is self:
            self.net.chaos = None

    # ------------------------------------------------------------- link seam
    def on_link(self, src: Any, dst: Any, packet: Any,
                now: float) -> Optional[float]:
        """Fate of one link traversal: None = drop, else extra delay (s)."""
        for p in self.plan.partitions:
            if p.separates(src, dst, now):
                self.stats.inc("partition_drops")
                return None
        if not self.plan.links:
            return 0.0
        kind = "interest" if isinstance(packet, Interest) else "data"
        extra = 0.0
        for rule in self.plan.links:
            if not rule.matches(src, dst, kind, now):
                continue
            if rule.loss > 0.0 and self._rng.random() < rule.loss:
                self.stats.inc(kind + "_drops")
                return None
            if rule.jitter_s > 0.0:
                extra += self._rng.uniform(0.0, rule.jitter_s)
                self.stats.inc("jitter_added")
        return extra

    # ------------------------------------------------------------- exec seam
    def exec_factor(self, node: Any, now: float) -> float:
        factor = 1.0
        for rule in self.plan.slow_nodes:
            if rule.active_for(node, now):
                factor *= rule.factor
                self.stats.inc("slow_samples")
        return factor

    # ----------------------------------------------------------- gossip seam
    def gossip_drop(self, subject: Any, observer: Any, now: float) -> bool:
        for rule in self.plan.gossip:
            if rule.active(now) and rule.loss > 0.0 \
                    and self._rng.random() < rule.loss:
                self.stats.inc("gossip_drops")
                return True
        return False

    # --------------------------------------------------------------- crashes
    def _crash(self, node: Any) -> None:
        if node in self.net.edge_nodes:
            self.stats.inc("crashes")
            self.net.crash_en(node)
