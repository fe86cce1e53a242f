"""Declarative fault schedules for the chaos controller (DESIGN.md §Fault
model).

A ``FaultPlan`` is pure data: a seed plus lists of fault rules, each scoped
by a virtual-time window ``[t_start, t_end)``.  The plan says *what can go
wrong and when*; the ``ChaosController`` (chaos.py) owns the RNG and decides
*whether each individual packet/round* is affected — so the same plan under
the same seed reproduces the same fault trace, and an empty plan provably
changes nothing (tests/test_cosim.py zero-fault parity golden).

Rule taxonomy:

* ``LinkFault``   — probabilistic loss and/or uniform latency jitter on link
                    traversals, scoped to an (a, b) node pair (None = any).
* ``Partition``   — deterministic cut: every packet crossing the group
                    boundary is dropped while the window is active.
* ``CrashEvent``  — crash-stop of an EN at an absolute time
                    (``ReservoirNetwork.crash_en``: store lost, no drain).
* ``SlowNode``    — service-time inflation factor for one EN's executions.
* ``GossipFault`` — probabilistic loss of federation telemetry snapshots
                    (per subject->observer delivery).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, FrozenSet, List, Optional


def _active(t_start: float, t_end: float, now: float) -> bool:
    return t_start <= now < t_end


@dataclasses.dataclass
class LinkFault:
    """Lossy / jittery link(s).  ``a``/``b`` of None match any endpoint;
    matching is symmetric (either traversal direction).  ``kinds`` restricts
    the rule to ``"interest"`` or ``"data"`` packets (``"both"`` default)."""

    a: Any = None
    b: Any = None
    loss: float = 0.0
    jitter_s: float = 0.0
    t_start: float = 0.0
    t_end: float = math.inf
    kinds: str = "both"  # 'interest' | 'data' | 'both'

    def matches(self, src: Any, dst: Any, kind: str, now: float) -> bool:
        if not _active(self.t_start, self.t_end, now):
            return False
        if self.kinds != "both" and kind != self.kinds:
            return False
        if self.a is None and self.b is None:
            return True
        if self.a is not None and self.b is not None:
            return {src, dst} == {self.a, self.b}
        pin = self.a if self.a is not None else self.b
        return pin in (src, dst)


@dataclasses.dataclass
class Partition:
    """Network cut: packets crossing the ``group`` boundary drop (both
    directions), deterministically, while the window is active."""

    group: FrozenSet[Any]
    t_start: float = 0.0
    t_end: float = math.inf

    def separates(self, src: Any, dst: Any, now: float) -> bool:
        if not _active(self.t_start, self.t_end, now):
            return False
        return (src in self.group) != (dst in self.group)


@dataclasses.dataclass
class CrashEvent:
    """Crash-stop of EN ``node`` at absolute virtual time ``at``."""

    node: Any
    at: float


@dataclasses.dataclass
class SlowNode:
    """Service-time inflation: EN ``node`` executes ``factor``x slower."""

    node: Any
    factor: float = 2.0
    t_start: float = 0.0
    t_end: float = math.inf

    def active_for(self, node: Any, now: float) -> bool:
        return node == self.node and _active(self.t_start, self.t_end, now)


@dataclasses.dataclass
class GossipFault:
    """Federation telemetry loss: each subject->observer snapshot delivery
    is dropped with probability ``loss`` while active."""

    loss: float = 0.0
    t_start: float = 0.0
    t_end: float = math.inf

    def active(self, now: float) -> bool:
        return _active(self.t_start, self.t_end, now)


@dataclasses.dataclass
class FaultPlan:
    """A seed-deterministic fault schedule (empty by default)."""

    links: List[LinkFault] = dataclasses.field(default_factory=list)
    partitions: List[Partition] = dataclasses.field(default_factory=list)
    crashes: List[CrashEvent] = dataclasses.field(default_factory=list)
    slow_nodes: List[SlowNode] = dataclasses.field(default_factory=list)
    gossip: List[GossipFault] = dataclasses.field(default_factory=list)
    seed: int = 0

    @property
    def empty(self) -> bool:
        return not (self.links or self.partitions or self.crashes
                    or self.slow_nodes or self.gossip)

    # ------------------------------------------------------------ builders
    @classmethod
    def uniform_loss(cls, rate: float, jitter_s: float = 0.0,
                     t_start: float = 0.0, t_end: float = math.inf,
                     seed: int = 0) -> "FaultPlan":
        """Uniform Interest/Data loss (+ optional jitter) on every link."""
        return cls(links=[LinkFault(loss=rate, jitter_s=jitter_s,
                                    t_start=t_start, t_end=t_end)],
                   seed=seed)

    def with_crash(self, node: Any, at: float) -> "FaultPlan":
        self.crashes.append(CrashEvent(node, at))
        return self

    def with_partition(self, group, t_start: float,
                       t_end: float) -> "FaultPlan":
        self.partitions.append(Partition(frozenset(group), t_start, t_end))
        return self

    def with_slow_node(self, node: Any, factor: float, t_start: float = 0.0,
                       t_end: float = math.inf) -> "FaultPlan":
        self.slow_nodes.append(SlowNode(node, factor, t_start, t_end))
        return self

    def with_gossip_loss(self, rate: float, t_start: float = 0.0,
                         t_end: float = math.inf) -> "FaultPlan":
        self.gossip.append(GossipFault(rate, t_start, t_end))
        return self
