"""Federator: cross-EN offloading over the NDN fabric (port of
``repro/federation/federator.py``, DESIGN.md §Federation).

Turns N co-simulated ENs into one load-balanced reuse fabric.  On a reuse
-store miss the owning EN asks an ``OffloadPolicy`` where the task should
execute; a remote choice becomes a *federated execution* — one more NDN
exchange layered on the machinery the simulator already has:

* the delegating EN forwards an Interest named
  ``/<remote-EN-prefix>/<svc>/task/<hash>`` toward the chosen EN (plain FIB
  forwarding, like the Fig. 3b result-fetch names; intermediate PIT entries
  aggregate identical federated names and CSes cache the returned Data),
* the executing EN runs the normal treatment — its own store may *hit*
  (the forwarding-error case of Fig. 10, recovered instead of measured),
  otherwise its compute backend executes and **its** store absorbs the
  insert, so rFIB bucket affinity is preserved for future near-duplicates,
* the result flows back as Data along the PIT reverse path; the delegating
  EN resolves the pending ``ExecCompletion`` future exactly as if a local
  backend had produced it (TTC answers, window-dedup followers, and the
  direct protocol all keep working unchanged).

Near-identical misses offloaded by *different* ENs to the same executor
share a federated name, so they coalesce: in-network via PIT aggregation
when the second Interest finds the first pending, and at the executing EN
via the ``_remote_inflight`` leader map when both reach the application.

Persistent skew triggers ``rfib.rebalance`` with load-derived weights —
bucket *ownership* shifts away from a hot EN, not just individual tasks.

Everything here is host-side logic on the virtual clock, as in the
reference.  What touches the device goes through the EN stores, which live
on the network's ``device``: ``peek_hit`` is a ``peek=True`` staged
``query_batch`` of one task (``gather_top1`` on a CUDA store),
``handle_remote`` a scalar ``query``, and ``handle_migration`` an
``insert_batch`` with the shipped buckets (no hash) and its page sync.  A
migration batch travels as the host copy ``ReuseStore.export`` made.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Any, Dict, List, Optional, Tuple

import networkx as nx
import numpy as np

from ..core.edge_node import ExecAborted, ExecCompletion
from ..core.lsh import normalize
from ..core.namespace import TASK_KEYWORD, decode_task_hash, parse_task_name
from ..core.network import APP_FACE
from ..core.packets import Data, Interest
from ..core.rfib import owners_batch
from ..core.sim_clock import Future
from ..obs.registry import CounterGroup

from .policy import LocalOnlyPolicy, OffloadContext, OffloadPolicy, get_policy
from .telemetry import PeerHealth, TelemetryGossip

# mid-range forwarder processing charge per hop for the RTT estimate
_HOP_PROC_S = 86e-6


def _batch_fingerprint(embs: np.ndarray) -> int:
    """Content fingerprint of a migration batch for the sanitizer's
    id-conservation ledger (crc32 over the canonical float32 bytes)."""
    return zlib.crc32(np.ascontiguousarray(
        np.asarray(embs, np.float32)).tobytes())


@dataclasses.dataclass
class _Offload:
    """One in-flight federated execution (delegating-EN side)."""

    src: Any
    dst: Any
    fed_name: str
    service: str
    interest: Interest           # the original task Interest
    emb: np.ndarray
    threshold: float
    out: Future                  # resolves with the ExecCompletion
    send_timer: Any = None       # lead-delay timer; cancelled on dst leave
    trace_sid: Any = None        # open tracer span (armed runs only)
    timeout_timer: Any = None    # re-dispatch deadline (fault layer)
    cancelled: bool = False      # re-dispatched elsewhere; do not send/retry


class Federator:
    """Reuse-aware cross-EN offloading + load-driven rFIB rebalance."""

    def __init__(
        self,
        net,
        policy,
        gossip_interval_s: float = 0.05,
        prop_delay_s: Optional[float] = None,
        rebalance: bool = True,
        rebalance_every_rounds: int = 20,   # check cadence, in gossip rounds
        rebalance_skew: float = 2.5,        # max/mean miss-rate ratio
        rebalance_persistence: int = 3,     # consecutive skewed checks
        rebalance_min_tasks: int = 64,      # misses per check window
        offload_timeout_s: float = 0.0,     # delegated-offload re-dispatch
                                            # deadline (0 = off: a fixed
                                            # deadline is workload-sensitive
                                            # — deep-backlog peers are slow,
                                            # not dead — so fault configs
                                            # opt in explicitly)
        dead_peer_detection: bool = True,   # telemetry-staleness detector
        suspect_after_s: Optional[float] = None,  # default 5x gossip interval
        dead_after_s: Optional[float] = None,     # default 12x gossip interval
        migrate_batch: int = 256,           # entries per migration Interest
        migrate_serialize_s_per_entry: float = 2e-6,  # per-entry source-side
                                            # serialization charge (~dim*4 B
                                            # at edge-link rate); batches ship
                                            # back-to-back after it
    ):
        self.net = net
        self.policy: OffloadPolicy = get_policy(policy)
        self.gossip = TelemetryGossip(net, interval_s=gossip_interval_s,
                                      prop_delay_s=prop_delay_s)
        self.gossip.on_round = self._on_gossip_round
        self.offload_timeout_s = float(offload_timeout_s)
        self.health: Optional[PeerHealth] = None
        if dead_peer_detection:
            self.health = PeerHealth(net, self.gossip,
                                     suspect_after_s=suspect_after_s,
                                     dead_after_s=dead_after_s,
                                     on_dead=self._peer_dead)
        self.rebalance_enabled = bool(rebalance)
        self.rebalance_every_rounds = int(rebalance_every_rounds)
        self.rebalance_skew = float(rebalance_skew)
        self.rebalance_persistence = int(rebalance_persistence)
        self.rebalance_min_tasks = int(rebalance_min_tasks)
        self._rounds_since_check = 0
        self._skewed_checks = 0
        self._miss_counts: Dict[Any, int] = {}
        self._remote_inflight: Dict[Tuple[Any, str], Future] = {}
        self._offloads_by_dst: Dict[Any, List[_Offload]] = {}
        self._rtt_cache: Dict[Tuple[Any, Any], float] = {}
        self.migrate_batch = int(migrate_batch)
        self.migrate_serialize_s_per_entry = float(migrate_serialize_s_per_entry)
        self._migrate_seq = itertools.count()
        self._autoscaler: Optional[Tuple[Any, Any, Any]] = None
        self.stats = CounterGroup({
            "decisions": 0, "offloads": 0, "remote_hits": 0,
            "remote_execs": 0, "remote_coalesced": 0, "rebalances": 0,
            "leave_redispatched": 0, "dropped_at_departed": 0,
            "offload_timeouts": 0, "timeout_redispatched": 0,
            "peers_dead": 0, "dead_redispatched": 0,
            # store migration (DESIGN.md §Store migration)
            "migrations": 0,           # migrate_out invocations
            "migrated_entries": 0,     # entries shipped (incl. reroutes)
            "migrate_batches": 0,      # migration Interests emitted
            "migrate_acks": 0,         # ack Data received back at sources
            "migrated_in": 0,          # entries landed at destinations
            "migrations_rerouted": 0,  # batches re-homed off a departed dst
            "stale_owner_hits": 0,     # remote hits at a no-longer-owner
            # autoscaling (attach_autoscaler)
            "scale_ups": 0, "scale_downs": 0,
        })
        reg = getattr(net, "registry", None)
        if reg is not None:
            reg.adopt("federation", self.stats)

    # ----------------------------------------------------------- decisions
    def note_activity(self) -> None:
        """A task Interest was expressed (first send or retransmission):
        keep the activity-gated gossip chain — and with it the failure
        detector / rebalance checker — alive while traffic flows.  Gating
        on *misses* alone (``decide``) left a hole: a hit-heavy workload
        stops calling ``decide`` once its clusters are warm, the chain
        dies, ``PeerHealth.check`` never runs again, and a crashed EN is
        never declared dead even while consumers retransmit against its
        prefix.  No-op when nothing consumes the rounds."""
        if self.rebalance_enabled or self.health is not None:
            self.gossip.kick()

    def decide(self, node: Any, svc_name: str, interest: Interest,
               emb: np.ndarray, threshold: float) -> Any:
        """Pick the EN a miss should execute on (``node`` = stay local)."""
        self.stats.inc("decisions")
        self._miss_counts[node] = self._miss_counts.get(node, 0) + 1
        if isinstance(self.policy, LocalOnlyPolicy):
            # parity fast path: skip the context build (normalize, task-hash
            # decode, live load snapshot) a local-only choose() would ignore
            self.note_activity()
            return node
        self.gossip.kick()
        if len(self.net.edge_nodes) < 2:
            return node
        views = self.gossip.views(node)
        if self.health is not None:
            # exclude suspect/dead peers from the candidate set (telemetry
            # -staleness detection); an unsuspected crashed EN remains a
            # candidate on purpose — offloading to it and timing out IS the
            # detection path, there is no omniscient membership check
            views = {n: s for n, s in views.items()
                     if not self.health.excluded(n)}
        if not views:
            return node
        ctx = OffloadContext(
            local=node, service=svc_name,
            emb=normalize(np.asarray(emb, np.float32).reshape(-1)),
            threshold=threshold, buckets=self._buckets_of(interest),
            now=self.net.loop.now, local_view=self.gossip.self_view(node),
            views=views, federator=self)
        target = self.policy.choose(ctx)
        if target == node:
            return node
        if target not in self.net.edge_nodes \
                and target not in self.net._crashed:
            return node  # unknown or announced-gone target; crashed targets
                         # stay eligible (the timeout path detects them)
        return target

    def _buckets_of(self, interest: Interest) -> Optional[np.ndarray]:
        try:
            _, kw, comp = parse_task_name(interest.name)
            if kw != TASK_KEYWORD:
                return None
            return np.asarray(decode_task_hash(
                comp, self.net.lsh_params.index_size_bytes))
        except ValueError:
            return None

    def _en_any(self, node: Any):
        """EdgeNode object regardless of membership state (live, departed,
        or crashed).  Policy inputs read crashed ENs' retained objects as
        *stale sketches* — the delegator cannot know the state is gone."""
        return (self.net.edge_nodes.get(node)
                or self.net._departed.get(node)
                or self.net._crashed.get(node))

    # -------------------------------------------------------- policy inputs
    def rtt_s(self, a: Any, b: Any) -> float:
        """EN-to-EN round trip: link delays + forwarder processing, cached."""
        key = (a, b)
        rtt = self._rtt_cache.get(key)
        if rtt is None:
            path = nx.shortest_path(self.net.graph, a, b)
            one_way = sum(
                self.net.graph.edges[u, v].get("delay", self.net.link_delay_s)
                for u, v in zip(path, path[1:]))
            one_way += _HOP_PROC_S * max(len(path) - 1, 1)
            rtt = 2.0 * one_way
            self._rtt_cache[key] = self._rtt_cache[(b, a)] = rtt
        return rtt

    def affinity(self, local: Any, node: Any, service: str,
                 buckets: Optional[np.ndarray]) -> float:
        """Fraction of the task's per-table buckets ``node`` owns (rFIB)."""
        if buckets is None:
            return 0.0
        entries = self.net.forwarders[local].rfib.entries(service)
        if not entries:
            return 0.0
        en = self._en_any(node)
        if en is None:
            return 0.0
        prefix = en.prefix
        owned = sum(
            any(e.en_prefix == prefix and e.covers(t, int(b))
                for e in entries)
            for t, b in enumerate(buckets))
        return owned / len(buckets)

    def peek_hit(self, node: Any, service: str, emb: np.ndarray,
                 threshold: float) -> bool:
        """Would ``node``'s store reuse this task?  Pure ``peek=True`` read
        (no LRU refresh, no statistics) — models a gossiped store sketch."""
        en = self._en_any(node)
        store = en.stores.get(service) if en is not None else None
        if store is None or not len(store):
            return False
        (_, _, idx), = store.query_batch(emb[None], threshold, peek=True)
        return idx is not None

    def search_s(self, node: Any, service: str) -> float:
        en = self._en_any(node)
        store = en.stores.get(service) if en is not None else None
        size = len(store) if store is not None else 1
        return self.net.delays.search_time_s(
            self.net.lsh_params.num_tables, max(size, 1))

    # ------------------------------------------------- delegating-EN side
    def offload(self, src: Any, dst: Any, svc_name: str, interest: Interest,
                emb: np.ndarray, threshold: float,
                lead_delay_s: float) -> Future:
        """Forward a miss to ``dst`` for federated execution.

        Returns a Future[ExecCompletion] resolving when the remote Data
        arrives back at ``src`` — a drop-in for ``ComputeBackend.submit``,
        so every downstream consumer (TTC answers, direct delivery, window
        -dedup leader futures) works unchanged.  ``lead_delay_s`` charges
        the local LSH search that discovered the miss before the federated
        Interest leaves, exactly like the local execute path."""
        net = self.net
        en_src = net.edge_nodes[src]
        fed_name = self._en_any(dst).prefix + interest.name
        out = Future()
        rec = _Offload(src, dst, fed_name, svc_name, interest,
                       np.asarray(emb, np.float32), threshold, out)
        self._offloads_by_dst.setdefault(dst, []).append(rec)
        self.stats.inc("offloads")
        en_src.stats.inc("offloaded")
        tr = net.loop.tracer
        if tr is not None:
            tmeta = net._task_meta.get(interest.name)
            if tmeta is not None:
                # the offload span lives on the originating task's track;
                # aliasing the federated name onto the task's meta keeps hop
                # instants attributed while the Interest crosses the fabric
                rec.trace_sid = tr.begin(
                    "offload", "federation", tmeta[0],
                    task=tmeta[0], src=str(src), dst=str(dst))
                net._task_meta.setdefault(fed_name, tmeta)

        def on_data(data: Data, t: float) -> None:
            recs = self._offloads_by_dst.get(rec.dst, [])
            if rec in recs:
                recs.remove(rec)
            if rec.timeout_timer is not None:
                rec.timeout_timer.cancel()
                rec.timeout_timer = None
            reuse = data.meta.get("reuse")
            self._close_offload(
                rec, "remote-hit" if reuse is not None else "remote-exec")
            comp = ExecCompletion(
                data.content, t,
                reuse="en" if reuse is not None else None,
                similarity=float(data.meta.get("similarity", 1.0)),
                remote_en=data.meta.get("en", en_src.prefix),
                stale_owner=bool(data.meta.get("stale_owner", False)))
            out.try_set_result(comp, now=t)

        def send() -> None:
            rec.send_timer = None
            if rec.cancelled:
                return  # re-dispatched (leave or peer-dead) during the lead
                        # delay; a crashed-but-undetected dst is NOT skipped
                        # here — the Interest goes out and the offload
                        # timeout is the recovery path
            fed_int = Interest(fed_name, app_params={
                "service": svc_name, "input": rec.emb,
                "threshold": threshold, "federated": True,
                "origin": en_src.prefix,
            })
            net._pending_cb.setdefault((src, fed_name), []).append(on_data)
            fwd = net.forwarders[src]
            actions = fwd.on_interest(fed_int, APP_FACE, net.loop.now)
            net._emit(src, actions, net.loop.now)

        if self.offload_timeout_s > 0:
            rec.timeout_timer = net.loop.call_later(
                lead_delay_s + self.offload_timeout_s,
                self._offload_timeout, rec)
        if lead_delay_s > 0:
            rec.send_timer = net.loop.call_later(lead_delay_s, send)
        else:
            send()
        return out

    def _close_offload(self, rec: _Offload, outcome: str) -> None:
        """Close an offload's tracer span (idempotent; no-op disarmed) and
        drop the federated-name alias from the task meta map."""
        tr = self.net.loop.tracer
        if tr is not None:
            tr.end(rec.trace_sid, outcome=outcome)
            rec.trace_sid = None
            self.net._task_meta.pop(rec.fed_name, None)

    def _offload_timeout(self, rec: _Offload) -> None:
        """Re-dispatch deadline fired: the remote reply is overdue.

        Suspects the target (direct evidence for the failure detector) and
        re-executes the task *locally* via the raw compute backend —
        guaranteed progress even when every peer looks unhealthy.  The
        pending Data callback stays registered: a merely-slow remote reply
        can still win the race (first outcome resolves ``rec.out``)."""
        rec.timeout_timer = None
        if rec.out.done or rec.cancelled:
            return
        # designed race: the pending Data callback stays registered, so a
        # merely-slow remote reply may still try to resolve after the
        # redispatch (or the src-gone abort) settled the future
        rec.out.allow_late()
        self.stats.inc("offload_timeouts")
        self._close_offload(rec, "timeout")
        if self.health is not None:
            self.health.note_timeout(rec.dst)
        recs = self._offloads_by_dst.get(rec.dst, [])
        if rec in recs:
            recs.remove(rec)
        if rec.src not in self.net.edge_nodes:
            rec.out.try_set_exception(
                ExecAborted("offload source %r gone at timeout" % (rec.src,)),
                now=self.net.loop.now)
            return
        self.stats.inc("timeout_redispatched")
        fut = self.net.backend.submit(
            rec.src, rec.service, rec.interest, rec.emb, 0.0)
        fut.add_done_callback(lambda f, out=rec.out: f.propagate(out))

    def _peer_dead(self, node: Any) -> None:
        """PeerHealth declared ``node`` dead: purge every structure that
        still references it and re-dispatch its in-flight offloads."""
        self.stats.inc("peers_dead")
        self._rtt_cache.clear()
        for key in [k for k in self._remote_inflight if k[0] == node]:
            self._remote_inflight.pop(key, None)
        for rec in self._offloads_by_dst.pop(node, []):
            rec.cancelled = True
            if rec.send_timer is not None:
                rec.send_timer.cancel()
                rec.send_timer = None
            if rec.timeout_timer is not None:
                rec.timeout_timer.cancel()
                rec.timeout_timer = None
            self.net._pending_cb.pop((rec.src, rec.fed_name), None)
            self._close_offload(rec, "peer-dead")
            if rec.out.done or rec.src not in self.net.edge_nodes:
                continue
            self.stats.inc("dead_redispatched")
            fut = self.net.backend.submit(
                rec.src, rec.service, rec.interest, rec.emb, 0.0)
            fut.add_done_callback(lambda f, out=rec.out: f.propagate(out))
        self.net.on_peer_dead(node)

    # --------------------------------------------------- executing-EN side
    def handle_remote(self, node: Any, interest: Interest) -> None:
        """Treat a federated task at the executing EN.

        Bypasses the EN batch window (the delegating EN already searched and
        the policy already paid a decision latency); coalesces identical
        in-flight federated names onto one leader execution; a store hit
        answers directly; a miss goes to this EN's own compute backend so
        the result is inserted *here* (bucket affinity preserved)."""
        net = self.net
        en = net.edge_nodes.get(node)
        if en is None:  # departed while the Interest was in flight
            self.stats.inc("dropped_at_departed")
            return
        svc_name = interest.app_params["service"]
        emb = np.asarray(interest.app_params["input"], np.float32)
        threshold = float(interest.app_params.get("threshold", 0.0))
        name = interest.name
        key = (node, name)
        leader = self._remote_inflight.get(key)
        if leader is not None:
            # follower rides the leader future: one execution, N replies
            en.stats.inc("remote_coalesced")
            self.stats.inc("remote_coalesced")
            tr = net.loop.tracer
            if tr is not None:
                tmeta = net._task_meta.get(name)
                if tmeta is not None:
                    tr.instant("remote-coalesced", "federation", tmeta[0],
                               node=str(node), task=tmeta[0])
            leader.add_done_callback(
                lambda f: None if f.exception is not None
                else self._reply_remote(node, name, f.result))
            return
        store = en.stores[svc_name]
        search_t = net.delays.search_time_s(
            net.lsh_params.num_tables, max(len(store), 1))
        result, sim, idx = store.query(emb, threshold)
        net.registry.observe_phase("search", search_t)
        tr = net.loop.tracer
        tmeta = net._task_meta.get(name) if tr is not None else None
        if tmeta is not None:
            tr.instant("remote-hit" if idx is not None else "remote-exec",
                       "federation", tmeta[0], node=str(node), task=tmeta[0],
                       similarity=float(sim))
        if idx is not None:
            en.stats.inc("reused")
            en.stats.inc("remote_hits")
            self.stats.inc("remote_hits")
            meta = {"reuse": "en", "similarity": sim, "en": en.prefix}
            if self._serving_stale(node, en, svc_name, name):
                # hit served off a no-longer-owner (reuse-affinity peek or a
                # stale forwarding hint): state the rFIB stopped routing here
                # still answered — the stranded-store symptom migration fixes
                meta["stale_owner"] = True
                en.stats.inc("stale_owner_hits")
                self.stats.inc("stale_owner_hits")
            data = Data(name, content=result, meta=meta)
            net._send_from_en(node, data, search_t)
            return
        en.stats.inc("remote_execs")
        self.stats.inc("remote_execs")
        fut = net.backend.submit(node, svc_name, interest, emb, search_t)
        self._remote_inflight[key] = fut

        def done(f: Future) -> None:
            self._remote_inflight.pop(key, None)
            if f.exception is not None:
                return  # executor crashed mid-run: no reply, the
                        # delegator's offload timeout recovers the task
            self._reply_remote(node, name, f.result)

        fut.add_done_callback(done)

    def _serving_stale(self, node: Any, en, svc_name: str,
                       fed_name: str) -> bool:
        """True when ``en`` answers a federated task whose buckets the rFIB
        now assigns to a *different* EN (post-rebalance stranded state)."""
        task_name = fed_name[len(en.prefix):]
        try:
            _, kw, comp = parse_task_name(task_name)
        except ValueError:
            return False
        if kw != TASK_KEYWORD:
            return False
        owner = self.net.forwarders[node].rfib.lookup(svc_name, comp)
        return owner is not None and owner.en_prefix != en.prefix

    def _reply_remote(self, node: Any, name: str, comp: ExecCompletion) -> None:
        """Send the executing EN's result back as Data on the PIT path."""
        net = self.net
        en = net._en_of(node)
        meta: Dict[str, Any] = {"reuse": comp.reuse, "en": en.prefix}
        if comp.reuse is not None:
            meta["similarity"] = comp.similarity
        data = Data(name, content=comp.result, meta=meta)
        net._send_from_en(node, data, max(comp.t_done - net.loop.now, 0.0))

    # ------------------------------------------------------------ EN leave
    def on_en_leave(self, node: Any) -> None:
        """Fail in-flight offloads over: re-decide each task bound for the
        departed EN (its reply can never come) and drop its gossip views."""
        self.gossip.forget(node)
        self._rtt_cache.clear()
        for key in [k for k in self._remote_inflight if k[0] == node]:
            self._remote_inflight.pop(key, None)
        for rec in self._offloads_by_dst.pop(node, []):
            rec.cancelled = True
            if rec.send_timer is not None:  # Interest not even sent yet
                rec.send_timer.cancel()
                rec.send_timer = None
            if rec.timeout_timer is not None:
                rec.timeout_timer.cancel()
                rec.timeout_timer = None
            self.net._pending_cb.pop((rec.src, rec.fed_name), None)
            self._close_offload(rec, "en-leave")
            if rec.out.done:
                continue
            self.stats.inc("leave_redispatched")
            fut = self.net._submit_execution(
                rec.src, rec.service, rec.interest, rec.emb, rec.threshold,
                0.0)
            fut.add_done_callback(lambda f, out=rec.out: f.propagate(out))

    # ------------------------------------------------------------- EN join
    def on_en_join(self, node: Any) -> None:
        """A new EN joined (or a gracefully-departed one rejoined): readmit
        it to the gossip views, seed its heartbeat so the failure detector
        measures staleness from the join rather than epoch 0, and drop the
        RTT cache (the topology gained links)."""
        self.gossip.welcome(node)
        self._rtt_cache.clear()
        if self.health is not None:
            self.health.revive(node)

    # ---------------------------------------------------- store migration
    def migrate_out(self, src: Any, dst: Any, svc: str,
                    ids: List[int]) -> int:
        """Hand ``src``'s reuse entries ``ids`` (store slots) to ``dst``.

        Remove-at-send semantics: ``extract`` atomically exports and
        tombstones the slots at the source, so a slot can never answer
        locally *and* be re-admitted remotely.  A batch lost to a dst crash
        is plain cache loss — re-execution regenerates the entries — never
        duplicated or corrupted state.  Batches ride the NDN fabric as
        Interests named ``/<dst-prefix>/<svc>/migrate/<seq>`` (plain FIB
        forwarding on the dst prefix); the ack Data retraces the PIT path.
        Returns the number of entries shipped."""
        net = self.net
        en_src = self._en_any(src)
        store = en_src.stores[svc]
        live = set(store.live_ids())
        exp = store.extract([i for i in ids if i in live])
        n = len(exp)
        if n == 0:
            return 0
        self.stats.inc("migrations")
        en_src.stats.inc("migrated_out", n)
        delay = 0.0
        for s in range(0, n, self.migrate_batch):
            e = min(s + self.migrate_batch, n)
            # source-side serialization: batches leave back-to-back, each
            # charged for packing its own entries before it hits the wire
            delay += self.migrate_serialize_s_per_entry * (e - s)
            self._send_migration(
                src, dst, svc, exp.embeddings[s:e], exp.results[s:e],
                exp.buckets[s:e], delay)
        return n

    def _send_migration(self, src: Any, dst: Any, svc: str,
                        embs: np.ndarray, results: List[Any],
                        buckets: np.ndarray, delay_s: float) -> None:
        net = self.net
        seq = next(self._migrate_seq)
        name = f"{self._en_any(dst).prefix}/{svc}/migrate/{seq}"
        self.stats.inc("migrate_batches")
        self.stats.inc("migrated_entries", len(results))
        tr = net.loop.tracer
        if tr is not None:
            tr.instant("migrate-send", "migration", tr.track("migrate"),
                       batch=name, src=str(src), dst=str(dst), n=len(results))
        san = net.loop.sanitizer
        if san is not None:
            san.note_migration_out(name, len(results),
                                   _batch_fingerprint(embs))

        def on_ack(data: Data, t: float) -> None:
            self.stats.inc("migrate_acks")
            if net.loop.tracer is not None:
                net.loop.tracer.instant(
                    "migrate-ack", "migration",
                    net.loop.tracer.track("migrate"), batch=data.name)

        net._pending_cb.setdefault((src, name), []).append(on_ack)

        def send() -> None:
            if src in net._crashed:
                if san is not None:
                    san.note_migration_lost(name, "source crashed pre-send")
                return  # source died holding the export: the batch is lost
            mig_int = Interest(name, app_params={
                "migrate": True, "service": svc,
                "embeddings": np.asarray(embs, np.float32),
                "results": list(results),
                "buckets": np.asarray(buckets),
                "origin": self._en_any(src).prefix,
            })
            fwd = net.forwarders[src]
            actions = fwd.on_interest(mig_int, APP_FACE, net.loop.now)
            net._emit(src, actions, net.loop.now)

        if delay_s > 0:
            net.loop.call_later(delay_s, send)
        else:
            send()

    def handle_migration(self, node: Any, interest: Interest) -> None:
        """A migration batch reached its new bucket owner: admit the entries
        with their original admission-time buckets (NOT re-hashed — the rFIB
        routes by those buckets) and ack so the source's PIT trail clears."""
        net = self.net
        san = net.loop.sanitizer
        en = net.edge_nodes.get(node)
        if en is None:
            if san is not None:
                san.note_migration_lost(interest.name,
                                        "destination crashed before admit")
            return  # raced a crash; the batch is lost (plain cache loss)
        p = interest.app_params
        svc = p["service"]
        store = en.stores[svc]
        embs = np.asarray(p["embeddings"], np.float32)
        if san is not None:
            san.note_migration_in(interest.name, len(p["results"]),
                                  _batch_fingerprint(embs))
        store.insert_batch(embs, list(p["results"]),
                           buckets=np.asarray(p["buckets"]))
        store.sync_device()  # absorb the page uploads off the query path
        n = len(p["results"])
        en.stats.inc("migrated_in", n)
        self.stats.inc("migrated_in", n)
        tr = net.loop.tracer
        if tr is not None:
            tr.instant("migrate-recv", "migration", tr.track("migrate"),
                       batch=interest.name, node=str(node), n=n)
        ack = Data(interest.name, content={"migrated": n},
                   meta={"control": "migrate-ack", "cacheable": False,
                         "en": en.prefix})
        net._send_from_en(node, ack, 0.0)

    def reroute_migration(self, node: Any, interest: Interest) -> None:
        """A migration batch landed on a *departed* dst: re-home each entry
        to its current owner under the live partition and ack the original
        name so the source's PIT breadcrumbs clear."""
        net = self.net
        p = interest.app_params
        svc = p["service"]
        embs = np.asarray(p["embeddings"], np.float32)
        results = list(p["results"])
        buckets = np.atleast_2d(np.asarray(p["buckets"]))
        self.stats.inc("migrations_rerouted")
        tr = net.loop.tracer
        if tr is not None:
            tr.instant("migrate-reroute", "migration", tr.track("migrate"),
                       batch=interest.name, node=str(node))
        san = net.loop.sanitizer
        if san is not None:
            # the original batch DID arrive (at the departed dst); the
            # re-homed shipments below open fresh ledger entries
            san.note_migration_in(interest.name, len(results),
                                  _batch_fingerprint(embs))
        ack = Data(interest.name, content={"migrated": 0, "rerouted": True},
                   meta={"control": "migrate-ack", "cacheable": False})
        net._send_from_en(node, ack, 0.0)
        entries = net.forwarders[node].rfib.entries(svc)
        owners = owners_batch(entries, buckets)
        prefix_node = {net.edge_nodes[n].prefix: n for n in net.en_nodes}
        groups: Dict[str, List[int]] = {}
        for i, o in enumerate(owners):
            if o is not None and o in prefix_node:
                groups.setdefault(o, []).append(i)
        for o in sorted(groups):
            idxs = groups[o]
            self.stats.inc("migrated_entries", len(idxs))
            self._send_migration(
                node, prefix_node[o], svc, embs[idxs],
                [results[i] for i in idxs], buckets[idxs], 0.0)

    # --------------------------------------------------------- autoscaling
    def attach_autoscaler(self, policy, scale_up, scale_down) -> None:
        """Wire an ``AutoscalePolicy``: evaluated once per gossip round on
        live backend load snapshots.  ``scale_up()`` / ``scale_down()``
        perform the membership change itself (benchmarks bind them to
        ``net.add_en`` / ``net.remove_en``), so the policy stays a pure
        sizing decision."""
        self._autoscaler = (policy, scale_up, scale_down)

    def _check_autoscale(self) -> None:
        policy, up, down = self._autoscaler
        net = self.net
        now = net.loop.now
        n = len(net.en_nodes)
        snaps = {node: net.backend.load_snapshot(node, now)
                 for node in net.en_nodes}
        desired = policy.desired(now, snaps, n)
        if desired > n:
            self.stats.inc("scale_ups")
            up()
        elif desired < n:
            self.stats.inc("scale_downs")
            down()

    # ----------------------------------------------------------- rebalance
    def _on_gossip_round(self) -> None:
        if self.health is not None:
            self.health.check()  # live ENs just published: age ~0 for them
        if self._autoscaler is not None:
            self._check_autoscale()
        if not self.rebalance_enabled:
            return
        self._rounds_since_check += 1
        if self._rounds_since_check < self.rebalance_every_rounds:
            return
        self._rounds_since_check = 0
        counts = dict(self._miss_counts)
        self._miss_counts = {}
        total = sum(counts.values())
        # en_nodes order — the SAME order rebalance_service derives the
        # prefix list in, so the positional weights line up by construction
        ens = list(self.net.en_nodes)
        if total < self.rebalance_min_tasks or len(ens) < 2:
            self._skewed_checks = 0
            return
        rates = np.asarray([counts.get(n, 0) for n in ens], np.float64)
        if rates.max() < self.rebalance_skew * max(rates.mean(), 1e-9):
            self._skewed_checks = 0
            return
        self._skewed_checks += 1
        if self._skewed_checks < self.rebalance_persistence:
            return
        self._skewed_checks = 0
        self._rebalance(ens, rates)

    def _rebalance(self, ens: List[Any], rates: np.ndarray) -> None:
        """Shift bucket ownership away from hot ENs (weighted re-partition).

        New share ~ current share / observed miss rate (equalizes expected
        arrivals if popularity is locally uniform), blended 50/50 with the
        current share to damp oscillation and floored so no EN is starved
        out of the partition entirely."""
        net = self.net
        nb = net.lsh_params.effective_buckets
        for svc in list(net.services):
            entries = net.forwarders[ens[0]].rfib.entries(svc)
            widths = {e.en_prefix: (e.ranges[0][1] - e.ranges[0][0] + 1)
                      for e in entries}
            shares = np.asarray(
                [widths.get(net.edge_nodes[n].prefix, 0) / nb for n in ens])
            target = shares / np.maximum(rates, 1.0)
            target /= max(target.sum(), 1e-12)
            weights = 0.5 * shares + 0.5 * target
            weights = np.maximum(weights, 0.25 / len(ens))
            net.rebalance_service(svc, weights=list(weights / weights.sum()),
                                  _notify_backend=False)
        net.backend.on_partition_change()  # once, on the final partition
        self.stats.inc("rebalances")
