"""Reuse-aware offload policies (federation layer, DESIGN.md §Federation).

When an EN's reuse store misses, the federator asks a policy *where the
task should execute*: locally (today's behavior) or on a remote EN reached
over the NDN fabric.  Deduplicator (arXiv:2405.02682) shows the decision
must co-design load balancing with computation reuse — naive least-loaded
dispatch scatters similar tasks away from the stores that could reuse them —
and ReStorEdge (arXiv:2405.17263) orchestrates exactly this reuse-aware
dispatch across distributed edge stores.  Three built-ins:

* ``local-only``     — always execute locally; the parity baseline (bit-for
                       -bit identical to the pre-federation simulator).
* ``least-loaded``   — classic load balancing on gossiped telemetry: offload
                       to the EN with the smallest expected wait, charged the
                       EN-to-EN RTT, with hysteresis so marginal wins don't
                       bounce tasks around.
* ``reuse-affinity`` — Deduplicator-style co-design: a remote EN is scored
                       by its expected *reuse probability* — how many of the
                       task's LSH-table buckets it owns in the rFIB, plus an
                       optional ``query_batch(peek=True)`` hint standing in
                       for a gossiped store sketch — weighed against its
                       load.  A confirmed remote hit turns a queued scratch
                       execution into one RTT + search; absent a hit, misses
                       stay with (partial) bucket owners so the *inserted*
                       result lands where future tasks will look for it.

Policies are pure deciders: they never mutate network state (the affinity
peek is a ``peek=True`` read — no LRU refresh, no statistics), so swapping
policies cannot perturb a trace beyond the offloads themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from ..core.edge_node import LoadSnapshot


@dataclasses.dataclass
class OffloadContext:
    """Everything a policy may consult for one miss, pre-gathered."""

    local: Any                           # EN node the miss happened at
    service: str
    emb: np.ndarray                      # normalized input embedding
    threshold: float
    buckets: Optional[np.ndarray]        # (T,) per-table LSH buckets
    now: float
    local_view: LoadSnapshot             # live local telemetry
    views: Dict[Any, LoadSnapshot]       # gossiped remote telemetry
    federator: Any                       # rtt_s / affinity / peek helpers


class OffloadPolicy:
    """Decide where a reuse-store miss executes; return the chosen EN node.

    ``choose`` must return ``ctx.local`` or a key of ``ctx.views``."""

    name = "base"

    def choose(self, ctx: OffloadContext) -> Any:
        raise NotImplementedError


class LocalOnlyPolicy(OffloadPolicy):
    """Today's behavior: every miss executes where the rFIB routed it."""

    name = "local-only"

    def choose(self, ctx: OffloadContext) -> Any:
        return ctx.local


class LeastLoadedPolicy(OffloadPolicy):
    """Load balancing blind to reuse: minimize expected wait + RTT.

    ``hysteresis_s`` keeps marginal differences from ping-ponging tasks:
    an offload must beat local execution by at least the hysteresis after
    paying the full EN-to-EN round trip."""

    name = "least-loaded"

    def __init__(self, hysteresis_s: float = 0.01):
        self.hysteresis_s = float(hysteresis_s)

    def choose(self, ctx: OffloadContext) -> Any:
        local_cost = ctx.local_view.wait_s(ctx.now)
        best, best_cost = ctx.local, local_cost
        for node, snap in ctx.views.items():
            cost = snap.wait_s(ctx.now) + ctx.federator.rtt_s(ctx.local, node)
            if cost < best_cost:
                best, best_cost = node, cost
        if best is not ctx.local and local_cost - best_cost < self.hysteresis_s:
            return ctx.local
        return best


class ReuseAffinityPolicy(OffloadPolicy):
    """Reuse/load co-design (Deduplicator-style scoring).

    Per remote EN the expected completion cost is::

        rtt + search                       if a peek hint confirms a hit
        rtt + wait - affinity * service_s * affinity_weight   otherwise

    where ``affinity`` is the fraction of the task's LSH-table buckets the
    EN owns in the local rFIB.  The affinity discount keeps offloaded misses
    at (partial) bucket owners — the executed result is inserted into the
    *executing* EN's store, so landing it where the rFIB sends future
    near-duplicates preserves reuse; scattering it to a random idle EN
    (least-loaded) strands it.  ``peek_hint`` gates the per-candidate
    ``query_batch(peek=True)`` probe (a stand-in for a gossiped occupancy
    sketch; see benchmarks/reuse_store_scale.py skewed-occupancy rows for
    the measured recall such a hint provides)."""

    name = "reuse-affinity"

    def __init__(self, hysteresis_s: float = 0.01,
                 affinity_weight: float = 0.5, peek_hint: bool = True):
        self.hysteresis_s = float(hysteresis_s)
        self.affinity_weight = float(affinity_weight)
        self.peek_hint = bool(peek_hint)

    def choose(self, ctx: OffloadContext) -> Any:
        fed = ctx.federator
        # Costs are estimated completion times, so a confirmed remote HIT
        # (which skips execution entirely) naturally dominates any execute
        # candidate: exec costs carry the full expected service time.
        local_cost = ctx.local_view.wait_s(ctx.now) + ctx.local_view.service_s
        best, best_cost = ctx.local, local_cost
        for node, snap in ctx.views.items():
            rtt = fed.rtt_s(ctx.local, node)
            if self.peek_hint and fed.peek_hit(node, ctx.service, ctx.emb,
                                               ctx.threshold):
                # a confirmed remote hit: no queueing, no execution — the
                # remote store answers after one search
                cost = rtt + fed.search_s(node, ctx.service)
            else:
                aff = fed.affinity(ctx.local, node, ctx.service, ctx.buckets)
                cost = (rtt + snap.wait_s(ctx.now) + snap.service_s
                        - self.affinity_weight * aff * snap.service_s)
            if cost < best_cost:
                best, best_cost = node, cost
        if best is not ctx.local and local_cost - best_cost < self.hysteresis_s:
            return ctx.local
        return best


class AutoscalePolicy:
    """Fleet-sizing decision from gossiped load telemetry (NOT an
    ``OffloadPolicy`` — it sizes the fleet, it does not place tasks).

    Evaluated once per gossip round (``Federator.attach_autoscaler``) on the
    live per-EN ``LoadSnapshot``s.  The signal is the fleet-mean expected
    wait: above ``high_wait_s`` for ``persistence`` consecutive rounds the
    policy asks for one more EN; below ``low_wait_s`` equally persistently,
    one fewer.  Every decision arms a ``cooldown_rounds`` freeze so the
    membership change — re-partition, store migration, engine spin-up —
    settles before the next verdict (hysteresis against flapping).  With
    bucket-granular store migration wired into ``add_en``/``remove_en``,
    both directions preserve the warm reuse state, which is what lets p99
    and reuse-hit stay pinned through scaling (BENCH_migration.json)."""

    def __init__(self, high_wait_s: float = 0.25, low_wait_s: float = 0.02,
                 min_ens: int = 2, max_ens: int = 16, persistence: int = 3,
                 cooldown_rounds: int = 10):
        self.high_wait_s = float(high_wait_s)
        self.low_wait_s = float(low_wait_s)
        self.min_ens = int(min_ens)
        self.max_ens = int(max_ens)
        self.persistence = int(persistence)
        self.cooldown_rounds = int(cooldown_rounds)
        self._hot = 0
        self._cold = 0
        self._cooldown = 0

    def desired(self, now: float, snaps: Dict[Any, LoadSnapshot],
                n: int) -> int:
        """Target fleet size given the current snapshots; ``n`` = live ENs."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return n
        if not snaps:
            return n
        waits = [s.wait_s(now) for s in snaps.values()]
        mean_wait = sum(waits) / len(waits)
        if mean_wait > self.high_wait_s:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.persistence and n < self.max_ens:
                self._hot = 0
                self._cooldown = self.cooldown_rounds
                return n + 1
        elif mean_wait < self.low_wait_s:
            self._cold += 1
            self._hot = 0
            if self._cold >= self.persistence and n > self.min_ens:
                self._cold = 0
                self._cooldown = self.cooldown_rounds
                return n - 1
        else:
            self._hot = self._cold = 0
        return n


_POLICIES = {
    LocalOnlyPolicy.name: LocalOnlyPolicy,
    LeastLoadedPolicy.name: LeastLoadedPolicy,
    ReuseAffinityPolicy.name: ReuseAffinityPolicy,
}

POLICY_NAMES = tuple(sorted(_POLICIES))


def get_policy(policy) -> OffloadPolicy:
    """Resolve a policy name or pass an ``OffloadPolicy`` instance through."""
    if isinstance(policy, OffloadPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown offload policy {policy!r}; known: {POLICY_NAMES}"
        ) from None
