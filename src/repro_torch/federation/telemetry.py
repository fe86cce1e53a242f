"""Per-EN load telemetry gossip (federation layer, DESIGN.md §Federation).

Every EN periodically publishes a ``LoadSnapshot`` — queue depth, parallel
execution lanes, EWMA service time — captured from its compute backend
(``ComputeBackend.load_snapshot``: the inline busy-until horizon or the
serving engine's in-flight/batcher state).  Snapshots propagate to every
other EN on the shared ``sim_clock`` EventLoop, so an offload policy decides
on *stale* views: a remote EN's state is at most ``interval_s`` (plus the
EN-to-EN propagation delay) old, exactly the information regime a real
gossip protocol provides.  ``LoadSnapshot.wait_s(now)`` compensates the
known part of that staleness by draining the observed backlog at 1 s/s.

The gossip chain is activity-gated (``RepeatingTimer``): it ticks only while
tasks keep arriving and stops itself when the network goes idle, so a
drain-to-idle ``EventLoop.run()`` still terminates.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

from ..core.edge_node import LoadSnapshot
from ..core.sim_clock import RepeatingTimer


class TelemetryGossip:
    """EN-to-EN load dissemination on the network's event loop.

    ``views(observer)`` returns the freshest snapshot the observer has
    *received* for every other EN; the observer's own state is always read
    live (``self_view``) — an EN knows its own queue exactly.
    """

    def __init__(self, net, interval_s: float = 0.05,
                 prop_delay_s: Optional[float] = None):
        self.net = net
        self.interval_s = float(interval_s)
        # EN-to-EN propagation: one core-link traversal unless overridden
        self.prop_delay_s = (net.link_delay_s if prop_delay_s is None
                             else float(prop_delay_s))
        self._views: Dict[Any, Dict[Any, LoadSnapshot]] = {}
        self._active = False
        # honest membership: views drop ENs that *gracefully announced* a
        # leave (forget()), never ENs that merely stopped publishing — a
        # crashed EN stays visible (and increasingly stale) until the
        # failure detector (PeerHealth) declares it dead.  The old filter
        # consulted live net membership, which made every observer
        # omnisciently crash-aware.
        self._gone: Set[Any] = set()
        # central per-EN last-publish time: heartbeat absence is the
        # failure detector's staleness signal.  Deliberately NOT routed
        # through the lossy gossip seam — a publish is the EN being alive;
        # per-observer delivery loss must not fake a peer death.
        self.last_publish: Dict[Any, float] = {}
        self.gossip_dropped = 0  # chaos-injected snapshot delivery drops
        self.rounds = 0
        self.on_round = None  # optional per-round hook (federation rebalance)
        self._timer: RepeatingTimer = net.loop.every(self.interval_s,
                                                     self._tick)
        self.publish_now()  # epoch-0 round: no EN starts blind

    # ------------------------------------------------------------- publish
    def kick(self) -> None:
        """Note activity (a task arrival/decision); keeps the chain alive."""
        self._active = True
        self._timer.kick()

    def _tick(self) -> bool:
        self.publish_now()
        if self.on_round is not None:
            self.on_round()
        active, self._active = self._active, False
        return active  # stop rescheduling once the network goes idle

    def publish_now(self) -> None:
        """One gossip round: snapshot every EN, deliver after propagation."""
        self.rounds += 1
        now = self.net.loop.now
        snaps = {node: self.net.backend.load_snapshot(node, now)
                 for node in self.net.en_nodes}
        for node in snaps:
            self.last_publish[node] = now
        reg = getattr(self.net, "registry", None)
        if reg is not None:
            # the gossip cadence is the metrics-snapshot cadence: one
            # per-interval registry row per round, load gauges included
            for node, snap in snaps.items():
                reg.gauge(f"load/{node}/depth").set(snap.depth)
                reg.gauge(f"load/{node}/service_s").set(snap.service_s)
            reg.snapshot(now)
        tr = self.net.loop.tracer
        if tr is not None:
            tr.instant("gossip-round", "gossip", tr.track("gossip"),
                       round=self.rounds, n_ens=len(snaps))
        if self.prop_delay_s > 0 and now > 0:
            self.net.loop.call_later(self.prop_delay_s, self._apply, snaps)
        else:  # epoch-0 seeding (and zero-delay configs) apply inline
            self._apply(snaps)

    def _apply(self, snaps: Dict[Any, LoadSnapshot]) -> None:
        chaos = getattr(self.net, "chaos", None)
        now = self.net.loop.now
        for obs in list(snaps):
            view = self._views.setdefault(obs, {})
            for subj, snap in snaps.items():
                if subj == obs:
                    continue
                if chaos is not None and chaos.gossip_drop(subj, obs, now):
                    self.gossip_dropped += 1
                    continue
                view[subj] = snap

    # --------------------------------------------------------------- views
    def self_view(self, node: Any) -> LoadSnapshot:
        """The observer's own state: always live, never stale."""
        return self.net.backend.load_snapshot(node, self.net.loop.now)

    def views(self, observer: Any) -> Dict[Any, LoadSnapshot]:
        """Latest *received* snapshot per remote EN (may be stale).

        Filters only ENs that *announced* a leave (``forget``) — a crashed
        EN keeps its last snapshot here and, because ``wait_s`` decays with
        age, looks increasingly idle and attractive until the failure
        detector suspects it.  Candidate filtering against suspects is the
        Federator's job (``decide``)."""
        view = self._views.get(observer, {})
        return {n: s for n, s in view.items() if n not in self._gone}

    def staleness_s(self, observer: Any) -> float:
        """Age of the oldest remote view (diagnostics)."""
        view = self.views(observer)
        if not view:
            return float("inf")
        now = self.net.loop.now
        return max(now - s.t for s in view.values())

    def forget(self, node: Any) -> None:
        """EN leave (announced) or dead verdict: drop its outbound views,
        everyone's view of it, and its heartbeat record."""
        self._gone.add(node)
        self._views.pop(node, None)
        self.last_publish.pop(node, None)
        for view in self._views.values():
            view.pop(node, None)

    def welcome(self, node: Any) -> None:
        """EN join (or graceful-leave rejoin): readmit it to the views and
        seed its heartbeat so staleness is measured from the join, not from
        epoch 0 — without this, the first ``PeerHealth.check`` after a join
        would insta-declare the newcomer dead."""
        self._gone.discard(node)
        self.last_publish[node] = self.net.loop.now


class PeerHealth:
    """Staleness-driven failure detector over the gossip heartbeat
    (DESIGN.md §Fault model).

    An EN that stops publishing (crash-stop leaves no announcement) ages out
    of ``TelemetryGossip.last_publish``:

    * age >= ``suspect_after_s`` — *suspect*: excluded from offload
      candidate views, but routing is untouched (cheap, reversible: a fresh
      publish clears the suspicion).  Offload timeouts also suspect their
      target immediately (``note_timeout``) — direct evidence beats waiting
      for staleness.
    * age >= ``dead_after_s``   — *dead*: irreversible verdict.  The peer is
      forgotten from gossip, its pending offloads re-dispatched and routing
      re-partitioned via ``on_dead`` (Federator._peer_dead ->
      ReservoirNetwork.on_peer_dead).

    ``check()`` runs on every gossip round, right after the live ENs
    publish, so a live EN's age is ~0 at check time and false verdicts need
    the EN to actually miss ``suspect_after_s / interval_s`` consecutive
    publishes.  Thresholds default to 5x / 12x the gossip interval."""

    def __init__(self, net, gossip: TelemetryGossip,
                 suspect_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 on_dead: Optional[Callable[[Any], None]] = None):
        self.net = net
        self.gossip = gossip
        self.suspect_after_s = (gossip.interval_s * 5.0
                                if suspect_after_s is None
                                else float(suspect_after_s))
        self.dead_after_s = (gossip.interval_s * 12.0
                             if dead_after_s is None else float(dead_after_s))
        self.on_dead = on_dead
        self.suspects: Set[Any] = set()
        self.dead: Dict[Any, float] = {}  # node -> virtual declare time

    def note_timeout(self, node: Any) -> None:
        """Direct evidence (an offload to ``node`` timed out): suspect it
        now instead of waiting for staleness.  A live node clears itself on
        its next publish round."""
        if node not in self.dead:
            self.suspects.add(node)

    def excluded(self, node: Any) -> bool:
        return node in self.suspects or node in self.dead

    def check(self) -> None:
        now = self.net.loop.now
        for node, last in list(self.gossip.last_publish.items()):
            age = now - last
            if age >= self.dead_after_s:
                self.declare_dead(node)
            elif age >= self.suspect_after_s:
                self.suspects.add(node)
            else:
                self.suspects.discard(node)

    def revive(self, node: Any) -> None:
        """EN join: clear any leftover suspect/dead verdict for the id
        (a gracefully-departed EN may rejoin under the same name)."""
        self.suspects.discard(node)
        self.dead.pop(node, None)

    def declare_dead(self, node: Any) -> None:
        if node in self.dead:
            return
        self.dead[node] = self.net.loop.now
        self.suspects.discard(node)
        self.gossip.forget(node)
        if self.on_dead is not None:
            self.on_dead(node)
