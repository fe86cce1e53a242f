"""Reservoir network: discrete-event simulation of the full framework.

Port of ``repro/core/network.py``.  Mirrors the paper's evaluation
methodology (§V-B real-world testbed and §V-C ndnSIM study): NetworkX-
generated AS-like topologies, 5 ms core links, users attached via 2 ms
links, 10 ENs, NDN forwarders on every node, ENs running the reuse store,
clients hashing inputs with LSH and offloading tasks.

Processing delays are *calibrated to the paper's measurements* so completion
-time ratios are comparable: FIB 71–101 µs, rFIB 74–106 µs, LSH hashing per
Table III, LSH search per Table IVb, service execution 70–100 ms.  The same
delay model parameters can be replaced with values measured by our own
benchmarks (see ``benchmarks/``).

The simulator supports two modes:
  * ``reservoir`` — the full design (LSH names, CS reuse, PIT aggregation,
    rFIB majority-vote routing with forwarding hints, EN reuse store).
  * ``icedge``   — the ICedge baseline (§V-D): per-application forwarding at
    every hop (77–111 µs), no in-network CS reuse for tasks, EN reuse keyed
    on coarse name semantics instead of LSH similarity.

The simulator is host-side Python on the virtual clock, as in the
reference: routing, forwarding and every time stay floats and the
reference's draws.  What runs on ``device`` (None: the CUDA card) is the
reuse decision: the clients' LSH hash (``lsh_hash_mix``), and every EN
reuse store (``gather_top1`` for the scalar query, window flushes and the
forwarding-error peeks; the fused pipeline for windows of
``fused_min_batch`` tasks or more).  Virtual times come from
``PaperDelayModel``, so they do not depend on the device.

Federation (``offload_policy``, store migration on re-partition and EN
leave, failover) is ``repro_torch.federation``'s ``Federator``, created
lazily as in the reference; a ``faults.ChaosController`` fills the
``chaos`` hooks.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import networkx as nx
import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs.registry import CounterGroup, MetricsRegistry
from .edge_node import ComputeBackend, EdgeNode, InlineBackend, Service
from .forwarder import Forwarder
from .lsh import LSHParams, get_lsh, normalize
from .namespace import make_task_name, parse_task_name
from .packets import Data, Interest
from .rfib import owners_batch, partition, rebalance
from .sim_clock import EventLoop, Future, Timer

APP_FACE = 0  # face id reserved for the local application on every node


# --------------------------------------------------------------------- delays
class PaperDelayModel:
    """Delay parameters calibrated to the paper's measured values."""

    HASH_MS = {1: 0.4, 5: 1.7, 10: 3.3}  # Table III
    # Table IVb: (tables -> (ms @ 20k items, ms @ 100k items))
    SEARCH_MS = {1: (0.09, 0.22), 5: (1.08, 3.92), 10: (1.43, 4.40)}

    def __init__(self, exec_time_s: Tuple[float, float] = (0.070, 0.100)):
        self.exec_time_s = exec_time_s

    @staticmethod
    def _interp(table: Dict[int, float], k: int) -> float:
        ks = sorted(table)
        if k in table:
            return table[k]
        if k <= ks[0]:
            return table[ks[0]] * k / ks[0]
        if k >= ks[-1]:
            return table[ks[-1]] * k / ks[-1]
        lo = max(x for x in ks if x < k)
        hi = min(x for x in ks if x > k)
        f = (k - lo) / (hi - lo)
        return table[lo] + f * (table[hi] - table[lo])

    def hash_time_s(self, num_tables: int) -> float:
        return self._interp(self.HASH_MS, num_tables) * 1e-3

    def search_time_s(self, num_tables: int, store_size: int) -> float:
        lo = {k: v[0] for k, v in self.SEARCH_MS.items()}
        hi = {k: v[1] for k, v in self.SEARCH_MS.items()}
        at20, at100 = self._interp(lo, num_tables), self._interp(hi, num_tables)
        slope = (at100 - at20) / 80_000.0
        return max(0.0, (at20 + slope * (store_size - 20_000))) * 1e-3


# -------------------------------------------------------------------- records
@dataclasses.dataclass
class _ReadyEntry:
    """TTC-protocol result awaiting its deferred fetch (paper Fig. 3b).

    ``resolved`` is False while an engine-backed execution is still in
    flight: ``done`` is then only the current TTC *estimate* and early
    fetches are answered with a refreshed estimate.  ``timer`` is the TTL
    expiry guard (tasks whose users never fetch must not leak entries)."""

    done: float
    result: Any = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resolved: bool = False
    timer: Optional[Timer] = None
    service: str = ""


@dataclasses.dataclass
class TaskRecord:
    task_id: int
    user: str
    service: str
    name: str
    t_submit: float
    t_complete: float = -1.0
    reuse: Optional[str] = None  # 'user' | 'cs' | 'en' | None (executed)
    reuse_node: Optional[str] = None
    aggregated: bool = False     # completed by waiting on an in-flight
                                 # near-identical leader (window dedup), not
                                 # by an instantly-available stored result
    similarity: float = -1.0
    correct: Optional[bool] = None
    true_result: Any = None
    result: Any = None
    forwarding_error: bool = False
    retx: int = 0                # consumer retransmissions sent for this task
    failed: bool = False         # gave up (retx budget exhausted / NACKed out)
    remote_en: Optional[str] = None  # federated: EN that actually answered
    stale_owner: bool = False    # served off a store that no longer owns the
                                 # task's buckets (pre-migration remote peek)

    @property
    def completion_time(self) -> float:
        return self.t_complete - self.t_submit


@dataclasses.dataclass
class Metrics:
    records: List[TaskRecord] = dataclasses.field(default_factory=list)

    def completed(self) -> List[TaskRecord]:
        return [r for r in self.records if r.t_complete >= 0]

    def by_reuse(self, kind) -> List[TaskRecord]:
        kinds = kind if isinstance(kind, (tuple, list, set)) else (kind,)
        return [r for r in self.completed() if r.reuse in kinds]

    def mean_completion(self, kind=None) -> float:
        rs = self.completed() if kind is None else self.by_reuse(kind)
        return float(np.mean([r.completion_time for r in rs])) if rs else float("nan")

    def reuse_fraction(self, kind=None) -> float:
        done = self.completed()
        if not done:
            return 0.0
        if kind is None:
            return sum(r.reuse is not None for r in done) / len(done)
        return len(self.by_reuse(kind)) / len(done)

    def completion_rate(self) -> float:
        """Fraction of submitted tasks that completed (fault runs: tasks can
        be lost to link loss past the retransmission budget or EN crashes)."""
        if not self.records:
            return 1.0
        return len(self.completed()) / len(self.records)

    def retransmissions(self) -> int:
        return sum(r.retx for r in self.records)

    def accuracy(self) -> float:
        reused = [r for r in self.completed() if r.reuse is not None]
        if not reused:
            return float("nan")
        return sum(bool(r.correct) for r in reused) / len(reused)

    def local_en_fraction(self) -> float:
        """Fraction of completed tasks answered by the rFIB-routed EN's own
        store (reuse == 'en' with no federated detour) — the quantity store
        migration pins through churn: without it, rebalanced buckets keep
        hitting remotely off the old owner (see ``stale_owner_fraction``)."""
        done = self.completed()
        if not done:
            return 0.0
        return sum(r.reuse == "en" and r.remote_en is None
                   for r in done) / len(done)

    def stale_owner_fraction(self) -> float:
        """Fraction of completed tasks served by an EN that had already lost
        ownership of their buckets (stranded-store symptom)."""
        done = self.completed()
        if not done:
            return 0.0
        return sum(r.stale_owner for r in done) / len(done)

    def forwarding_error_rate(self) -> float:
        """Paper Fig. 10: 'percent of tasks forwarded to an EN that does not
        have a similar task to reuse, [while] such a similar task is stored
        at another EN' — errors over ALL offloaded tasks."""
        done = self.completed()
        if not done:
            return 0.0
        return sum(r.forwarding_error for r in done if r.reuse is None) / len(done)

    def summary(self) -> Dict[str, float]:
        return {
            "tasks": len(self.completed()),
            "mean_ct_scratch": self.mean_completion(kind=(None,)),
            "mean_ct_cs": self.mean_completion(kind=("cs", "user")),
            "mean_ct_en": self.mean_completion(kind="en"),
            "reuse_pct": 100 * self.reuse_fraction(),
            "reuse_pct_cs": 100 * self.reuse_fraction(("cs", "user")),
            "reuse_pct_en": 100 * self.reuse_fraction("en"),
            "accuracy_pct": 100 * self.accuracy(),
            "fwd_error_pct": 100 * self.forwarding_error_rate(),
        }


# ------------------------------------------------------------------- network
class ReservoirNetwork:
    """Event-driven NDN edge network with Reservoir (or ICedge) semantics."""

    def __init__(
        self,
        graph: nx.Graph,
        en_nodes: List[Any],
        lsh_params: LSHParams,
        mode: str = "reservoir",
        link_delay_s: float = 0.005,
        user_link_delay_s: float = 0.002,
        cs_capacity: int = 512,
        user_cs_capacity: int = 32,
        en_store_capacity: int = 100_000,
        en_batch_window_s: float = 0.0,  # >0: EN-side batch window (reservoir)
        delay_model: Optional[PaperDelayModel] = None,
        icedge_tag_bits: int = 4,
        measure_fwd_errors: bool = False,
        protocol: str = "direct",      # 'direct' | 'ttc' (paper Fig. 3b)
        large_input_bytes: int = 0,    # >0: Fig. 3c pull path for big inputs
        input_chunk_bytes: int = 8192,
        en_ready_ttl_s: float = 60.0,  # TTC results kept past completion
        backend: Optional[ComputeBackend] = None,  # EN execute-path seam
        offload_policy: Any = None,    # federation: name | OffloadPolicy
        federation_kw: Optional[Dict[str, Any]] = None,
        retx_timeout_s: Optional[float] = None,  # consumer retransmission:
                                       # initial timeout (None/0 = off, the
                                       # legacy lossless-fabric behaviour)
        retx_backoff: float = 2.0,     # exponential backoff multiplier
        retx_max: int = 4,             # retries before giving up (failed)
        pit_lifetime_s: Optional[float] = None,  # None = entries never age
                                       # out (legacy: expire() was dead code,
                                       # so the seed fabric had an infinite
                                       # effective lifetime); set a finite
                                       # lifetime alongside retx so retrans-
                                       # missions refresh live entries
        pit_sweep_interval_s: float = 1.0,  # PIT aging tick (event-driven)
        store_migration: bool = True,  # ship stranded reuse entries to their
                                       # new bucket owners on every ownership
                                       # change (rebalance / leave / join);
                                       # False reproduces the pre-migration
                                       # stranded-store behaviour
        trace: Optional[bool] = None,  # None defers to RESERVOIR_TRACE
        profile: Optional[bool] = None,  # None defers to RESERVOIR_PROFILE
        seed: int = 0,
        device: DeviceLike = None,     # the client hash and the EN stores
    ):
        assert mode in ("reservoir", "icedge")
        assert protocol in ("direct", "ttc")
        assert backend is None or mode == "reservoir", \
            "compute backends model the reservoir execute path only"
        self.mode = mode
        self.protocol = protocol
        self.large_input_bytes = large_input_bytes
        self.input_chunk_bytes = input_chunk_bytes
        self.en_ready_ttl_s = float(en_ready_ttl_s)
        self._en_ready: Dict[Tuple[Any, str], _ReadyEntry] = {}
        self.measure_fwd_errors = measure_fwd_errors
        self._pending_cb: Dict[Tuple[Any, str], List[Callable]] = {}
        # --- fault layer (DESIGN.md §Fault model)
        self.chaos = None              # faults.ChaosController attaches here
        self._crashed: Dict[Any, EdgeNode] = {}  # crash-stop: state LOST
        self.retx_timeout_s = retx_timeout_s or 0.0
        self.retx_backoff = float(retx_backoff)
        self.retx_max = int(retx_max)
        self.pit_lifetime_s = (math.inf if pit_lifetime_s is None
                               else float(pit_lifetime_s))
        self._en_inflight: Dict[Tuple[Any, str], Future] = {}  # retx dedup
        self.fault_stats = CounterGroup({
            "retx_sent": 0,        # consumer retransmissions emitted
            "retx_give_ups": 0,    # tasks abandoned after retx_max retries
            "nacks_sent": 0,       # EN-side failures answered with a NACK
            "nacks_received": 0,   # NACKs that reached a consumer callback
            "crashed_ens": 0,      # crash_en invocations
            "crash_drops": 0,      # packets that died at a crashed EN app
            "crash_recoveries": 0,  # dead-peer verdicts that re-partitioned
        })
        self.graph = graph
        self.lsh_params = lsh_params
        self.device = resolve_device(device)
        self.lsh = get_lsh(lsh_params, self.device)
        self.delays = delay_model or PaperDelayModel()
        self.link_delay_s = link_delay_s
        self.user_link_delay_s = user_link_delay_s
        self.icedge_tag_bits = icedge_tag_bits
        self.store_migration = bool(store_migration)
        self._seed = seed
        self._cs_capacity = cs_capacity
        self._en_store_capacity = en_store_capacity
        self._rng = random.Random(seed)
        # RESERVOIR_SANITIZE arms invariant checks; RESERVOIR_TRACE /
        # RESERVOIR_PROFILE (or the explicit kwargs) arm observability
        self.loop = EventLoop(trace=trace, profile=profile)
        self._san = self.loop.sanitizer
        if self._san is not None:
            self._san.add_idle_check(self._audit_pit_drained)
        # observability (DESIGN.md §Observability): the tracer mirrors the
        # sanitizer's arming (RESERVOIR_TRACE / EventLoop(trace=...)); the
        # registry is ALWAYS on (purely observational, cannot perturb the
        # seeded goldens) and re-homes every legacy stats dict below.
        self._tracer = self.loop.tracer
        self.registry = MetricsRegistry()
        self.registry.adopt("fault", self.fault_stats)
        # name -> [task_id, t_submit, open span id (None when disarmed)]:
        # hop/phase attribution for packets already in flight.  Entries are
        # registered at submit (plus fetch/federated aliases) and dropped at
        # completion / give-up.
        self._task_meta: Dict[str, List[Any]] = {}
        if self.loop.profiler is not None:
            self.loop.profiler.add_counter_source(
                "store_sync_pages", self._total_sync_pages)
        self.metrics = Metrics()
        self._task_ids = itertools.count()
        self.services: Dict[str, Service] = {}

        # --- build forwarders + faces
        self.forwarders: Dict[Any, Forwarder] = {}
        self.links: Dict[Tuple[Any, int], Tuple[Any, int, float]] = {}
        self._adjacency: Dict[Tuple[Any, Any], int] = {}  # (a, b) -> face at a
        self._face_count: Dict[Any, int] = {}
        for node in graph.nodes:
            # Stable per-node seed: ``hash(str)`` is salted per *process*, so
            # it made seeded runs irreproducible across invocations (and
            # pinned-golden parity tests impossible); crc32 is deterministic.
            self.forwarders[node] = Forwarder(
                f"/net/{node}", cs_capacity=cs_capacity,
                seed=seed + zlib.crc32(str(node).encode()) % 9973,
                pit_lifetime_s=self.pit_lifetime_s,
            )
            self._face_count[node] = APP_FACE + 1
        for a, b in graph.edges:
            d = graph.edges[a, b].get("delay", link_delay_s)
            self._connect(a, b, d)

        # --- edge nodes (attach EdgeNode app on APP_FACE of their node)
        self.en_nodes = list(en_nodes)
        self.edge_nodes: Dict[Any, EdgeNode] = {}
        for node in self.en_nodes:
            self.edge_nodes[node] = EdgeNode(
                f"/en/{node}", lsh_params, store_capacity=en_store_capacity,
                similarity="cosine", seed=seed + 17, device=self.device,
            )
            self.registry.adopt(f"en/{node}", self.edge_nodes[node].stats)
        # ICedge EN store: coarse-tag -> latest result
        self._icedge_store: Dict[Any, Dict[str, Tuple[np.ndarray, Any]]] = {
            node: {} for node in self.en_nodes
        }
        self._en_busy_until: Dict[Any, float] = {n: 0.0 for n in self.en_nodes}
        self.en_batch_window_s = float(en_batch_window_s)
        self._en_pending: Dict[Any, List[Interest]] = {n: [] for n in self.en_nodes}

        # --- PIT aging: event-driven sweep, activity-gated like the gossip
        # chain (ticks while any PIT holds entries, stops at idle so
        # drain-to-idle run() terminates).  kick()ed by every task arrival.
        self._pit_sweep = self.loop.every(float(pit_sweep_interval_s),
                                          self._pit_sweep_tick)

        # --- compute backend (EN execute-path seam; DESIGN.md §Co-sim)
        self.backend: ComputeBackend = backend or InlineBackend()
        self.backend.attach(self)

        # --- users
        self.users: Dict[str, Tuple[Any, Forwarder]] = {}
        self._user_cs_capacity = user_cs_capacity

        self._install_routes()

        # --- federation (DESIGN.md §Federation): cross-EN offloading of
        # reuse-store misses under a pluggable policy.  None keeps today's
        # local-only execute path without instantiating any federation
        # machinery; the named "local-only" policy instantiates it but must
        # stay bit-for-bit identical (tests/test_cosim.py parity).
        # ENs that leave mid-run are retained here so drained in-flight
        # completions and Fig. 3b ready-entry fetches still resolve.
        self._departed: Dict[Any, EdgeNode] = {}
        self.federator = None
        if offload_policy is not None:
            assert mode == "reservoir", "federation models the reservoir path"
            from ..federation import Federator  # lazy: no import cycle
            self.federator = Federator(self, offload_policy,
                                       **(federation_kw or {}))

    # -------------------------------------------------------------- plumbing
    def _connect(self, a: Any, b: Any, delay: float) -> None:
        fa, fb = self._face_count[a], self._face_count[b]
        self._face_count[a] += 1
        self._face_count[b] += 1
        self.links[(a, fa)] = (b, fb, delay)
        self.links[(b, fb)] = (a, fa, delay)
        self._adjacency[(a, b)] = fa
        self._adjacency[(b, a)] = fb

    def _install_routes(self) -> None:
        """Shortest-path FIB routes for every EN prefix from every node."""
        for en in self.en_nodes:
            paths = nx.shortest_path(self.graph, target=en, weight=None)
            prefix = self.edge_nodes[en].prefix
            for node, path in paths.items():
                if node == en:
                    self.forwarders[node].fib.insert(prefix, APP_FACE)
                    continue
                nxt = path[1]
                face = self._face_between(node, nxt)
                self.forwarders[node].fib.insert(prefix, face, cost=len(path))

    def _face_between(self, a: Any, b: Any) -> int:
        try:
            return self._adjacency[(a, b)]
        except KeyError:
            raise KeyError(f"no link {a}->{b}") from None

    # -------------------------------------------------------------- services
    def register_service(self, service: Service, num_buckets: int = None) -> None:
        """Register on all ENs + install rFIB partitions on all forwarders."""
        if num_buckets is None:
            num_buckets = self.lsh_params.effective_buckets
        svc = service.name.strip("/")
        self.services[svc] = service
        for en_node, en in self.edge_nodes.items():
            en.register(service)
        en_prefixes = [self.edge_nodes[n].prefix for n in self.en_nodes]
        for node, fwd in self.forwarders.items():
            faces = {
                self.edge_nodes[n].prefix: [
                    fwd.fib.next_hop(self.edge_nodes[n].prefix) or APP_FACE
                ]
                for n in self.en_nodes
            }
            for entry in partition(
                svc, en_prefixes, faces, self.lsh_params.num_tables,
                num_buckets, self.lsh_params.index_size_bytes,
            ):
                fwd.rfib.insert(entry)
            # route the bare service prefix to the nearest EN for FIB fallback
            nearest = min(
                self.en_nodes,
                key=lambda n: nx.shortest_path_length(self.graph, node, n)
                if node != n else 0,
            )
            fwd.fib.insert(f"/{svc}", faces[self.edge_nodes[nearest].prefix][0])

    def rebalance_service(self, service: str, weights=None,
                          num_buckets: Optional[int] = None,
                          _notify_backend: bool = True) -> None:
        """Re-partition a service's rFIB bucket ranges on EVERY forwarder.

        Used by the federation layer (load-driven weighted rebalance) and by
        ``remove_en`` (membership change).  User forwarders are included —
        their copied entries collapse onto the single upstream face exactly
        as ``add_user`` installed them.  ``_notify_backend=False`` lets
        multi-service callers batch the backend notification (one
        ``on_partition_change`` per membership change, not per service)."""
        svc = service.strip("/")
        if num_buckets is None:
            num_buckets = self.lsh_params.effective_buckets
        en_prefixes = [self.edge_nodes[n].prefix for n in self.en_nodes]
        # old partition snapshot: the migration diff below compares each
        # stored entry's pre- vs post-rebalance owner (ranges/prefixes are
        # identical across forwarders; only faces differ)
        old_entries = list(next(iter(self.forwarders.values()))
                           .rfib.entries(svc))
        for node, fwd in self.forwarders.items():
            faces = {}
            for p in en_prefixes:
                nh = fwd.fib.next_hop(p)
                if nh is None:
                    # APP_FACE (0) is a legitimate *falsy* next hop (the EN's
                    # own node); None means NO route — silently mapping it to
                    # APP_FACE (the old ``or APP_FACE``) installed a bogus
                    # local-delivery face for a prefix this node can't reach.
                    raise RuntimeError(
                        f"rebalance_service({svc!r}): node {node!r} has no "
                        f"FIB route toward EN prefix {p!r}; install routes "
                        "before re-partitioning")
                faces[p] = [nh]
            rebalance(fwd.rfib, svc, en_prefixes, faces,
                      self.lsh_params.num_tables, num_buckets,
                      self.lsh_params.index_size_bytes, weights=weights)
        # per-EN engine replica routers partition the EN's own rFIB slice
        # (the nested-partition fix, DESIGN.md §Co-sim) — they must follow
        # the ownership shift or replica routing degenerates to one edge
        # replica per EN
        if _notify_backend:
            self.backend.on_partition_change()
        self._migrate_service(svc, old_entries)

    def _migrate_service(self, svc: str, old_entries,
                         include: Optional[List[Any]] = None) -> None:
        """Ship stranded reuse entries to their new bucket owners.

        Diffs each live EN's store against the OLD vs NEW partition with the
        same per-table majority vote the rFIB routes by (``owners_batch``):
        an entry moves iff this EN owned its buckets before the change and a
        *different* EN owns them now — only moved ranges transfer.  With
        ``include`` (a departing EN retained in ``_departed``), everything
        live in that store is handed to its current owner regardless of the
        old partition: the source is leaving the fabric entirely.

        A no-op when ``store_migration`` is off or nothing moved — so a
        zero-churn run never instantiates a federator and stays bit-for-bit
        identical to the pre-migration simulator.
        """
        if not self.store_migration:
            return
        new_entries = list(next(iter(self.forwarders.values()))
                           .rfib.entries(svc))
        if not new_entries:
            return
        prefix_node = {self.edge_nodes[n].prefix: n for n in self.en_nodes}
        sources = list(self.en_nodes) if include is None else list(include)
        moves: List[Tuple[Any, Any, List[int]]] = []
        for node in sources:
            en = self._en_of(node)
            store = en.stores.get(svc)
            if store is None or not len(store):
                continue
            ids, bks = store.live_buckets()
            new_own = owners_batch(new_entries, bks)
            if node in self.edge_nodes:
                old_own = (owners_batch(old_entries, bks) if old_entries
                           else [None] * len(ids))
                keep = en.prefix
                sel = [(i, d) for i, o, d in zip(ids, old_own, new_own)
                       if o == keep and d is not None and d != keep]
            else:  # departing source: hand off every live entry
                sel = [(i, d) for i, d in zip(ids, new_own) if d is not None]
            by_dst: Dict[str, List[int]] = {}
            for i, d in sel:
                by_dst.setdefault(d, []).append(i)
            for dprefix in sorted(by_dst):
                dst = prefix_node.get(dprefix)
                if dst is not None and dst != node:
                    moves.append((node, dst, by_dst[dprefix]))
        if not moves:
            return
        fed = self._ensure_federator()
        for src, dst, id_list in moves:
            fed.migrate_out(src, dst, svc, id_list)

    def remove_en(self, node: Any) -> None:
        """EN leave: re-partition its bucket ranges across the survivors.

        The EdgeNode object is retained in ``self._departed`` so already
        -executing tasks drain gracefully (their completions still deliver)
        and pre-leave TTC ready entries still answer their fetches; but the
        node stops being a routing target: every service is re-partitioned
        across the remaining ENs, its reuse store is handed off to the new
        bucket owners before the drain completes (``store_migration``),
        window-buffered tasks are failed over immediately, and Interests
        still in flight toward the old entry are failed over on arrival
        (``_failover_interest``) instead of dangling.
        """
        en = self.edge_nodes.pop(node)
        self.en_nodes.remove(node)
        self._departed[node] = en
        self._icedge_store.pop(node, None)
        for svc in self.services:
            # survivors whose ranges shifted migrate via the per-service
            # rebalance; the departing store is handed off right after
            self.rebalance_service(svc, _notify_backend=False)
            self._migrate_service(svc, [], include=[node])
        self.backend.on_partition_change()  # once, on the final partition
        if self.federator is not None:
            self.federator.on_en_leave(node)
        for interest in self._en_pending.pop(node, []):
            self._failover_interest(node, interest)

    def add_en(self, node: Any, attach_to: Any = None,
               link_delay_s: Optional[float] = None,
               store_capacity: Optional[int] = None,
               weights=None) -> None:
        """EN join (elastic scale-up): attach a new edge node and carve its
        bucket ranges out of the existing partition.

        ``node`` may be a brand-new graph node (``attach_to`` names its
        upstream, default core link delay) or an existing forwarder-only
        node being promoted to an EN.  The join re-runs shortest-path route
        installation (every node learns the new prefix; the new node learns
        everyone else's), re-partitions every service, and — via the same
        ownership diff as a rebalance — pulls the stored entries of its new
        ranges from their previous owners, so the joining EN starts warm
        instead of converting its slice's hits into misses.
        """
        if node in self.edge_nodes:
            raise ValueError(f"{node!r} is already an EN")
        if node in self._crashed:
            raise ValueError(f"{node!r} crashed; crashed ids do not rejoin")
        if node not in self.graph:
            if attach_to is None:
                raise ValueError("a new node needs attach_to")
            d = self.link_delay_s if link_delay_s is None else float(link_delay_s)
            self.graph.add_node(node)
            self.forwarders[node] = Forwarder(
                f"/net/{node}", cs_capacity=self._cs_capacity,
                seed=self._seed + zlib.crc32(str(node).encode()) % 9973,
                pit_lifetime_s=self.pit_lifetime_s,
            )
            self._face_count[node] = APP_FACE + 1
            self.graph.add_edge(node, attach_to, delay=d)
            self._connect(node, attach_to, d)
        cap = (self._en_store_capacity if store_capacity is None
               else store_capacity)
        en = EdgeNode(f"/en/{node}", self.lsh_params, store_capacity=cap,
                      similarity="cosine", seed=self._seed + 17,
                      device=self.device)
        self.en_nodes.append(node)
        self.edge_nodes[node] = en
        self.registry.adopt(f"en/{node}", en.stats)
        self._departed.pop(node, None)  # a gracefully-left id may rejoin
                                        # (fresh state; the old store is gone)
        self._icedge_store[node] = {}
        self._en_busy_until[node] = 0.0
        self._en_pending[node] = []
        for svc in self.services.values():
            en.register(svc)
        self._install_routes()
        # the new node's bare-service FIB fallback (register_service installs
        # these only on nodes that existed at registration time)
        fwd = self.forwarders[node]
        for svc in self.services:
            fwd.fib.insert(f"/{svc}", APP_FACE)
        self.backend.on_en_join(node)
        if self.federator is not None:
            self.federator.on_en_join(node)
        for svc in self.services:
            self.rebalance_service(svc, weights=weights,
                                   _notify_backend=False)
        self.backend.on_partition_change()  # once, on the final partition

    def crash_en(self, node: Any) -> None:
        """Crash-stop (fail-stop, no drain) — the adversarial counterpart of
        graceful ``remove_en``:

        * the reuse store and all EN-side state are LOST (no failover of
          window-buffered tasks, no draining of in-flight completions);
        * pending TTC ready entries die with the node — fetches for them are
          dropped by ``_deliver_app``'s crash guard;
        * the routing fabric is NOT re-partitioned and no federation peer is
          notified: rFIB entries keep naming the dead EN until the
          federation layer's staleness detector declares it dead
          (``on_peer_dead``), which is exactly the blackout window a
          recovery benchmark measures;
        * the compute backend rejects every in-flight execution future with
          ``ExecAborted`` so waiters resolve (error path) instead of
          dangling past drain-to-idle.
        """
        en = self.edge_nodes.pop(node)
        self.en_nodes.remove(node)
        self._crashed[node] = en
        self.fault_stats.inc("crashed_ens")
        self._icedge_store.pop(node, None)
        self._en_pending.pop(node, None)
        for key in [k for k in self._en_ready if k[0] == node]:
            entry = self._en_ready.pop(key)
            if entry.timer is not None:
                entry.timer.cancel()
        for key in [k for k in self._en_inflight if k[0] == node]:
            self._en_inflight.pop(key, None)
        self.backend.on_en_crash(node)

    def on_peer_dead(self, node: Any) -> None:
        """Failure-detector verdict (federation layer, telemetry staleness):
        route around a crashed EN by re-partitioning every service's rFIB
        bucket ranges across the survivors.  Consumer retransmissions that
        kept timing out against the dead prefix then reach the new owner
        (cold store — the reuse-hit dip the recovery benchmark measures).
        No-op unless the node actually crashed: graceful leaves already
        re-partitioned in ``remove_en``."""
        if node not in self._crashed or node in self.edge_nodes:
            return
        for svc in self.services:
            self.rebalance_service(svc, _notify_backend=False)
        self.backend.on_partition_change()
        self.fault_stats.inc("crash_recoveries")

    def _total_sync_pages(self) -> int:
        """Device sync-page total across every live EN reuse store (profiler
        counter source)."""
        return sum(s.sync_pages_total + s.table_sync_pages_total
                   for en in self.edge_nodes.values()
                   for s in en.stores.values())

    def exec_inflation(self, node: Any) -> float:
        """Slow-node fault: multiplier on sampled execution times (1.0 when
        no chaos controller is attached or no rule is active)."""
        if self.chaos is None:
            return 1.0
        return self.chaos.exec_factor(node, self._now)

    def _audit_pit_drained(self) -> None:
        """Sanitizer idle check: a PIT entry still pending once the loop
        drains to idle is a black-holed Interest — nothing left on the heap
        can ever satisfy it (exactly the PR 6 stale-entry bug).  Names the
        chaos layer dropped, retransmission gave up on, or that died at a
        crashed node are excused via ``Sanitizer.note_loss``."""
        san = self._san
        for node, fwd in self.forwarders.items():
            for name in sorted(fwd.pit._table):
                if not san.is_excused(name):
                    san.fail("pit-leak",
                             f"PIT entry {name!r} at node {node!r} still "
                             "pending after drain-to-idle: the Interest is "
                             "black-holed (no event left can satisfy it)",
                             node=node, name=name)

    def _pit_sweep_tick(self) -> bool:
        """Periodic PIT aging on the event loop (was dead code: ``expire``
        existed but nothing ticked it, so unsatisfied entries leaked).
        Returns truthy while any PIT still holds entries, keeping the
        activity-gated chain alive exactly until the tables drain."""
        if self.pit_lifetime_s == math.inf:
            return False  # nothing can ever expire; keeping the chain alive
                          # on a stranded entry would make run() never drain
        now = self._now
        alive = False
        for node, fwd in self.forwarders.items():
            n = fwd.expire(now)
            if n:
                en = (self.edge_nodes.get(node) or self._departed.get(node)
                      or self._crashed.get(node))
                if en is not None:
                    en.stats.inc("pit_expired", n)
            if len(fwd.pit):
                alive = True
        return alive

    def _departed_receive(self, node: Any, interest: Interest) -> None:
        """App-face Interest at a departed EN's node (still a forwarder)."""
        if "service" not in interest.app_params:
            self._en_fetch(node, interest)  # pre-leave TTC ready entries
        elif interest.app_params.get("migrate"):
            # a migration batch whose destination left while it was in
            # flight: re-home the entries to their owners under the CURRENT
            # partition (the source already tombstoned them — dropping the
            # batch here would lose the reuse state being rescued)
            self._ensure_federator().reroute_migration(node, interest)
        elif interest.app_params.get("failover"):
            # a failover proxy whose target ALSO left before it arrived:
            # chain to the next owner (the proxy's waiter is another
            # departed node's app callback, not a Federator offload record,
            # so nobody else will re-dispatch it)
            self._failover_interest(node, interest)
        elif interest.app_params.get("federated"):
            # the delegating EN re-dispatched at leave time; late arrivals
            # are redundant — count and drop (PIT state expires upstream)
            if self.federator is not None:
                self.federator.stats.inc("dropped_at_departed")
        else:
            self._failover_interest(node, interest)

    def _ensure_federator(self):
        """The EN-leave failover path rides the federated exchange; a
        network run without an offload policy gets a non-offloading
        (local-only) federator on demand — with autonomous load-driven
        rebalance OFF: ``offload_policy=None`` promised no federation
        behavior beyond the failover proxying itself."""
        if self.federator is None:
            from ..federation import Federator  # lazy: no import cycle
            self.federator = Federator(self, "local-only", rebalance=False)
        return self.federator

    def _failover_interest(self, node: Any, interest: Interest) -> None:
        """Re-route a task whose rFIB entry was invalidated under it.

        The Interest was forwarded here via a hint minted from a since
        -replaced ``RFibEntry``; this node's (post-rebalance) rFIB now names
        the new owner.  Re-emitting under the *same* name would dangle: the
        PIT trail back to the user runs through this node and possibly
        shared upstream hops, so the retry would aggregate into an existing
        entry at the first shared forwarder and never reach the new owner.
        Instead the task is proxied over the federated exchange — a fresh
        ``/<new-owner-prefix>/...`` name — and the returning Data answers
        the original name from this node's app face, retracing the original
        PIT breadcrumbs to the user.  Proxies chain: when the Interest is
        itself a failover proxy whose target has since departed (name
        carries THIS node's prefix), the prefix is stripped, the next owner
        looked up, and the reply still answers the name the upstream waiter
        registered."""
        fwd = self.forwarders[node]
        orig_name = interest.name
        task_name = orig_name
        departed = self._departed.get(node)
        if departed is not None and task_name.startswith(departed.prefix):
            task_name = task_name[len(departed.prefix):]
        try:
            service, _, hash_comp = parse_task_name(task_name)
        except ValueError:
            return
        entry = fwd.rfib.lookup(service, hash_comp)
        if entry is None:
            return
        owner = next((n for n in self.en_nodes
                      if self.edge_nodes[n].prefix == entry.en_prefix), None)
        if owner is None:
            return
        self._ensure_federator()
        fed_name = entry.en_prefix + task_name

        def on_data(data: Data, t: float) -> None:
            reply = Data(orig_name, content=data.content,
                         meta=dict(data.meta))
            actions = fwd.on_data(reply, APP_FACE, self._now)
            self._emit(node, actions, self._now)

        self._pending_cb.setdefault((node, fed_name), []).append(on_data)
        fed_int = Interest(fed_name, app_params={
            **interest.app_params, "federated": True, "failover": True,
        })
        actions = fwd.on_interest(fed_int, APP_FACE, self._now)
        self._emit(node, actions, self._now)

    def add_user(self, user_id: str, attach_to: Any) -> None:
        node = f"user:{user_id}"
        self.graph.add_node(node)
        self.forwarders[node] = Forwarder(
            f"/user/{user_id}", cs_capacity=self._user_cs_capacity,
            seed=self._rng.randrange(1 << 30),
            pit_lifetime_s=self.pit_lifetime_s,
        )
        self._face_count[node] = APP_FACE + 1
        self.graph.add_edge(node, attach_to, delay=self.user_link_delay_s)
        self._connect(node, attach_to, self.user_link_delay_s)
        # user FIB: default route to attachment point
        face = self._face_between(node, attach_to)
        self.forwarders[node].fib.insert("/", face)
        # copy rFIB entries from attachment point (advertised by the network)
        att = self.forwarders[attach_to]
        for svc, entries in att.rfib._by_service.items():
            for e in entries:
                e2 = dataclasses.replace(e, faces=[face])
                self.forwarders[node].rfib.insert(e2)
            self.forwarders[node].fib.insert(f"/{svc}", face)
        for en in self.edge_nodes.values():
            self.forwarders[node].fib.insert(en.prefix, face)
        self.users[user_id] = (node, self.forwarders[node])

    # ------------------------------------------------------------ event loop
    @property
    def _now(self) -> float:
        return self.loop.now

    def at(self, t: float, fn: Callable, *args) -> Timer:
        return self.loop.at(t, fn, *args)

    def run(self, until: float = float("inf"), max_events: int = 5_000_000) -> float:
        t = self.loop.run(until, max_events)
        tr = self._tracer
        if tr is not None and not len(self.loop):
            # drain-to-idle: tasks that will never complete (lost past the
            # retransmission budget with retx disabled, stranded at a crashed
            # EN, ...) still close their spans — the well-formedness contract
            # is "no open spans once the loop is idle".
            for meta in self._task_meta.values():
                if meta[2] is not None:
                    tr.abandon(meta[2], why="unresolved-at-drain")
                    meta[2] = None
            # non-task spans (offloads whose reply was lost with the
            # re-dispatch deadline disabled, ...) get the same treatment: a
            # valid export never carries unclosed spans.
            for sid, _, _, _ in tr.open_spans():
                tr.abandon(sid, why="unresolved-at-drain")
        return t

    def _emit(self, node: Any, actions, now: float) -> None:
        for act in actions:
            t_out = now + act.delay_s
            if act.face == APP_FACE:
                self.at(t_out, self._deliver_app, node, act.packet)
            else:
                link = self.links.get((node, act.face))
                if link is None:
                    continue
                peer, peer_face, delay = link
                if self.chaos is not None:
                    # fault seam: loss/partition (None) or added jitter.
                    # App-face deliveries above are node-internal and exempt.
                    extra = self.chaos.on_link(node, peer, act.packet, t_out)
                    if extra is None:
                        if self._san is not None:
                            self._san.note_loss(act.packet.name,
                                                "chaos link drop")
                        if self._tracer is not None:
                            meta = self._task_meta.get(act.packet.name)
                            self._tracer.instant(
                                "drop", "fault",
                                meta[0] if meta else self._tracer.track("fault"),
                                t=t_out, link=f"{node}->{peer}",
                                task=meta[0] if meta else None)
                        continue
                    delay += extra
                self.at(t_out + delay, self._deliver, peer, peer_face, act.packet)

    def _deliver(self, node: Any, face: int, packet) -> None:
        fwd = self.forwarders[node]
        tr = self._tracer
        if tr is not None:
            meta = self._task_meta.get(packet.name)
            if meta is not None:
                tr.instant("hop", "forward", meta[0], node=str(node),
                           kind=type(packet).__name__.lower(), task=meta[0])
        if isinstance(packet, Interest):
            extra = 0.0
            if self.mode == "icedge" and "/ictask/" in packet.name:
                # ICedge: per-application forwarding logic at EVERY hop adds
                # 6-10us over the plain FIB path (§V-D: 77-111us vs 71-101us)
                extra = self._rng.uniform(6e-6, 10e-6)
            actions = fwd.on_interest(packet, face, self._now)
            for a in actions:
                a.delay_s += extra
        else:
            actions = fwd.on_data(packet, face, self._now)
        self._emit(node, actions, self._now)

    def _deliver_app(self, node: Any, packet) -> None:
        if node in self._crashed:
            # crash-stop: the EN application is gone (no drain, no NACK —
            # silence is the failure signal); the co-located forwarder keeps
            # routing transit traffic, only app-face deliveries die here.
            self.fault_stats.inc("crash_drops")
            if self._san is not None:
                self._san.note_loss(packet.name, f"crashed EN {node!r}")
            return
        if isinstance(packet, Interest):
            if node in self.edge_nodes:
                self._en_receive(node, packet)
            elif node in self._departed:
                self._departed_receive(node, packet)
        elif isinstance(packet, Data):
            cbs = self._pending_cb.pop((node, packet.name), [])
            for cb in cbs:
                cb(packet, self._now)

    def _en_of(self, node: Any) -> EdgeNode:
        """EN lookup that still resolves departed ENs (graceful drain:
        in-flight completions and pre-leave TTC ready entries outlive the
        EN's membership in the routing fabric)."""
        en = self.edge_nodes.get(node)
        return en if en is not None else self._departed[node]

    # ------------------------------------------------------------- EN logic
    def _en_receive(self, node: Any, interest: Interest) -> None:
        en = self.edge_nodes[node]
        if "service" not in interest.app_params:
            # deferred result fetch (paper Fig. 3b): /<EN-prefix>/<svc>/task/<h>
            self._en_fetch(node, interest)
            return
        if interest.app_params.get("migrate"):
            # store-migration batch landing at its new bucket owner
            self._ensure_federator().handle_migration(node, interest)
            return
        if interest.app_params.get("federated"):
            # federated execution (DESIGN.md §Federation): a remote EN's
            # miss, offloaded here.  Bypasses the batch window — the
            # delegating EN already searched — and coalesces in-flight
            # duplicates onto one leader execution.
            self.federator.handle_remote(node, interest)
            return
        if interest.retx and self.mode == "reservoir" \
                and self._en_retx_coalesce(node, interest):
            return
        if not interest.retx:
            # forward phase (paper Figs. 8-10 decomposition): submit -> first
            # arrival of the task Interest at its EN's application face
            tmeta = self._task_meta.get(interest.name)
            if tmeta is not None:
                self.registry.observe_phase("forward", self._now - tmeta[1])
        if self.mode == "reservoir" and self.en_batch_window_s > 0:
            # batch window (DESIGN.md §Array-native store): buffer tasks
            # arriving at this EN; one query_batch services the whole window.
            pending = self._en_pending[node]
            pending.append(interest)
            if self._tracer is not None:
                tmeta = self._task_meta.get(interest.name)
                if tmeta is not None:
                    self._tracer.instant("window-buffer", "window", tmeta[0],
                                         node=str(node), task=tmeta[0])
            if len(pending) == 1:
                self.at(self._now + self.en_batch_window_s,
                        self._flush_en_batch, node)
            return
        svc_name = interest.app_params["service"]
        svc = self.services[svc_name]
        store = en.stores[svc_name]
        search_t = self.delays.search_time_s(self.lsh_params.num_tables, max(len(store), 1))
        if self.mode == "reservoir":
            emb = np.asarray(interest.app_params["input"], np.float32)
            threshold = float(interest.app_params.get("threshold", 0.0))
            qres = store.query(emb, threshold)
            self._process_reservoir_task(node, interest, emb, threshold, qres,
                                         search_t)
        else:  # icedge
            emb = np.asarray(interest.app_params["input"], np.float32)
            tag = icedge_tag(emb, self.icedge_tag_bits)
            hit = self._icedge_store[node].get(tag)
            if hit is not None:
                data = Data(interest.name, content=hit[1],
                            meta={"reuse": "en", "similarity": 1.0, "en": en.prefix,
                                  "cacheable": False})
                self._send_from_en(node, data, search_t)
                return
            exec_t = svc.sample_exec_time(self._rng)
            result = svc.execute(emb)
            self._icedge_store[node][tag] = (emb, result)
            start = max(self._now, self._en_busy_until[node])
            done = start + exec_t
            self._en_busy_until[node] = done
            data = Data(interest.name, content=result,
                        meta={"reuse": None, "en": en.prefix, "cacheable": False})
            self._send_from_en(node, data, done - self._now)

    def _en_retx_coalesce(self, node: Any, interest: Interest) -> bool:
        """EN-side retransmission dedup (no duplicate execution).

        Nonce-level duplicates die at the PIT; a consumer *retransmission*
        carries a fresh nonce, so the EN itself must recognise work already
        in flight for the same name — otherwise every retry past the
        forwarders would execute the task again.  TTC-protocol tasks are
        recognised by their ready entry (answered with a refreshed TTC, the
        original answer may have been lost); direct-protocol tasks by the
        pending execution future (the single completion Data satisfies the
        retransmission-refreshed PIT trail) or the EN batch window buffer.
        Post-completion retransmissions fall through to the reuse store,
        which answers them as an honest store hit."""
        en = self.edge_nodes[node]
        key = (node, interest.name)
        if self.protocol == "ttc":
            entry = self._en_ready.get(key)
            if entry is not None:
                en.stats.inc("retx_coalesced")
                ttc = (max(entry.done - self._now, 1e-4) if entry.resolved
                       else self._backend_ttc(node, interest.name, entry))
                data = Data(interest.name,
                            content={"ttc": ttc, "en_prefix": en.prefix},
                            meta={"control": "ttc", "cacheable": False,
                                  "en": en.prefix})
                self._send_from_en(node, data, 0.0)
                return True
        if key in self._en_inflight:
            en.stats.inc("retx_coalesced")
            return True
        if any(p.name == interest.name
               for p in self._en_pending.get(node, ())):
            en.stats.inc("retx_coalesced")
            return True
        return False

    def _track_inflight(self, node: Any, name: str, fut: Future) -> None:
        """Register a pending execution for retransmission dedup.

        The entry must outlive the future's *resolution* up to the result's
        ``t_done``: the inline backend resolves at submit time with a future
        completion timestamp, and a retransmission arriving in between must
        coalesce (the result does not exist yet — a store hit now would be
        time travel)."""
        key = (node, name)
        self._en_inflight[key] = fut

        def clear() -> None:
            if self._en_inflight.get(key) is fut:
                self._en_inflight.pop(key, None)

        def on_done(f: Future) -> None:
            if f.exception is not None:
                clear()
            else:
                self.at(max(f.result.t_done, self._now), clear)

        fut.add_done_callback(on_done)

    def _process_reservoir_task(
        self,
        node: Any,
        interest: Interest,
        emb: np.ndarray,
        threshold: float,
        qres: Tuple[Any, float, Optional[int]],
        search_t: float,
        defer_inserts: Optional[List[Tuple[np.ndarray, Any]]] = None,
    ) -> Optional[Future]:
        """Treat one reservoir task given its (result, sim, idx) query result.

        ``defer_inserts`` (batch path): executed results are accumulated for a
        single ``insert_batch`` by the caller instead of inserted one-by-one.
        Returns the backend's ``ExecCompletion`` future for scratch tasks
        (the batch path deduplicates near-identical window followers against
        these) and ``None`` for reuse hits.
        """
        en = self.edge_nodes[node]
        svc_name = interest.app_params["service"]
        result, sim, idx = qres
        self.registry.observe_phase("search", search_t)
        tr = self._tracer
        if tr is not None:
            tmeta = self._task_meta.get(interest.name)
            if tmeta is not None:
                store = en.stores[svc_name]
                tr.complete("search", "search", tmeta[0], t0=self._now,
                            dur=search_t, task=tmeta[0], node=str(node),
                            fused=store.last_query_fused,
                            sync_pages=store.last_query_sync_pages,
                            hit=idx is not None, similarity=float(sim))
        if idx is not None:
            en.stats.inc("reused")
            data = Data(interest.name, content=result,
                        meta={"reuse": "en", "similarity": sim, "en": en.prefix})
            self._send_from_en(node, data, search_t)
            return None
        # miss -> execute from scratch (charge queueing on the EN)
        fwd_err = (
            self._oracle_other_en_hit(node, svc_name, emb, threshold)
            if self.measure_fwd_errors else False
        )
        # Fig. 3c: large inputs are pulled from the user in chunks,
        # but ONLY now that reuse proved impossible
        pull_delay = 0.0
        input_size = int(interest.app_params.get("input_size", 0))
        if self.large_input_bytes and input_size > self.large_input_bytes:
            nchunks = -(-input_size // self.input_chunk_bytes)
            rtt_est = 2 * (self.user_link_delay_s + 2 * self.link_delay_s)
            # pipelined chunk fetches: one RTT + serialisation tail
            pull_delay = rtt_est + (nchunks - 1) * 0.2e-3
        fut = self._submit_execution(node, svc_name, interest, emb,
                                     threshold, search_t + pull_delay,
                                     defer_inserts=defer_inserts)
        if self.protocol != "ttc":
            # ttc tasks are deduped via their ready entry; direct tasks via
            # the pending future (retransmission coalescing).
            self._track_inflight(node, interest.name, fut)
        if self.protocol == "ttc":
            # Fig. 3b: answer the task Interest with a TTC estimate; the
            # user fetches the result at /<EN-prefix>/<name> after TTC-RTT.
            # An inline future is already resolved (TTC is exact); an engine
            # future is pending, so the answer is the engine's TTCEstimator-
            # informed estimate and the ready entry fills in when the
            # engine's completion event fires.
            meta = {"reuse": None, "en": en.prefix, "fwd_error": fwd_err}
            if fut.done:
                comp = fut.result
                entry = self._store_ready(node, interest.name, comp.t_done,
                                          comp.result, meta, service=svc_name)
            else:
                est = max(self.backend.ttc_estimate(node, svc_name), 1e-4)
                entry = self._store_ready(node, interest.name,
                                          self._now + est, None, meta,
                                          resolved=False, service=svc_name)
                key = (node, interest.name)
                fut.add_done_callback(
                    lambda f: self._resolve_ready(key, entry, f))
            ttc_data = Data(
                interest.name,
                content={"ttc": entry.done - self._now,
                         "en_prefix": en.prefix},
                meta={"control": "ttc", "cacheable": False, "en": en.prefix})
            self._send_from_en(node, ttc_data, search_t)
        else:
            name = interest.name
            fut.add_done_callback(
                lambda f: self._deliver_completion(node, name, fwd_err, f))
        return fut

    def _submit_execution(
        self,
        node: Any,
        svc_name: str,
        interest: Interest,
        emb: np.ndarray,
        threshold: float,
        lead_delay_s: float,
        defer_inserts: Optional[List[Tuple[np.ndarray, Any]]] = None,
    ) -> Future:
        """Execute-or-offload seam for a reuse-store miss.

        Without a federator (or when the policy keeps the task local) this
        is exactly the backend submit.  An offloaded task skips the local
        insert entirely — the *executing* EN's store absorbs the result, so
        rFIB bucket affinity is preserved — and resolves with the remote
        Data's ``ExecCompletion``."""
        if self.federator is not None:
            target = self.federator.decide(node, svc_name, interest, emb,
                                           threshold)
            if target != node:
                return self.federator.offload(node, target, svc_name,
                                              interest, emb, threshold,
                                              lead_delay_s)
        return self.backend.submit(node, svc_name, interest, emb,
                                   lead_delay_s, defer_inserts=defer_inserts)

    def _flush_en_batch(self, node: Any) -> None:
        """Service all tasks buffered at an EN with one query_batch/service.

        The per-task search delay is the batched search amortised over the
        window (the measured speedup lives in benchmarks/reuse_store_scale).
        """
        pending = self._en_pending.get(node)  # None once the EN has left
        if not pending:
            return
        self._en_pending[node] = []
        en = self.edge_nodes[node]
        tr = self._tracer
        if tr is not None:
            tr.complete("en-window", "window", tr.track(f"en/{node}"),
                        t0=self._now - self.en_batch_window_s,
                        dur=self.en_batch_window_s, n=len(pending))
        by_svc: Dict[str, List[Interest]] = {}
        for interest in pending:
            by_svc.setdefault(interest.app_params["service"], []).append(interest)
        for svc_name, interests in by_svc.items():
            store = en.stores[svc_name]
            search_t = self.delays.search_time_s(
                self.lsh_params.num_tables, max(len(store), 1)) / len(interests)
            embs = np.stack([np.asarray(i.app_params["input"], np.float32)
                             for i in interests])
            thrs = np.asarray([float(i.app_params.get("threshold", 0.0))
                               for i in interests], np.float32)
            qres = store.query_batch(embs, thrs)
            to_insert: List[Tuple[np.ndarray, Any]] = []
            # Intra-window dedup: ``defer_inserts`` postpones store inserts
            # past the whole window, so without this two near-identical
            # tasks in one window would both execute from scratch.  The most
            # similar earlier miss above the follower's threshold becomes its
            # leader: the follower reuses the leader's result (reuse="en")
            # and completes when the leader's execution does.
            leaders: List[Tuple[np.ndarray, Future]] = []
            for interest, emb, thr, qr in zip(interests, embs, thrs, qres):
                _, _, idx = qr
                if idx is None and leaders:
                    sims = np.asarray([float(l[0] @ emb) for l in leaders])
                    best = int(np.argmax(sims))
                    if sims[best] >= float(thr):
                        self._window_follower(node, interest,
                                              leaders[best][1],
                                              float(sims[best]))
                        continue
                fut = self._process_reservoir_task(node, interest, emb,
                                                   float(thr), qr, search_t,
                                                   defer_inserts=to_insert)
                if fut is not None:
                    leaders.append((emb, fut))
            if to_insert:
                store.insert_batch(np.stack([e for e, _ in to_insert]),
                                   [r for _, r in to_insert])

    def _window_follower(self, node: Any, interest: Interest,
                         leader_fut: Future, sim: float) -> None:
        """Resolve a deduped window follower from its leader's execution.

        Reuse semantics match an EN store hit (the result exists once the
        leader finishes), so the Data answers directly even under the TTC
        protocol — paper Fig. 3a — at the leader's completion time.  With an
        engine backend the leader's future resolves at its completion event,
        so the follower's Data rides the same timeline (straggler-backup
        wins included)."""
        en = self.edge_nodes[node]
        en.stats.inc("reused")
        en.stats.inc("window_reuse")
        name = interest.name
        t_enq = self._now

        def deliver(fut: Future) -> None:
            if fut.exception is not None:
                return  # leader aborted (crash-stop); consumers re-express
            comp = fut.result
            # aggregate phase: window-dedup wait on the in-flight leader
            agg_s = max(comp.t_done - t_enq, 0.0)
            self.registry.observe_phase("aggregate", agg_s)
            tr = self._tracer
            if tr is not None:
                tmeta = self._task_meta.get(name)
                if tmeta is not None:
                    tr.complete("aggregate", "aggregate", tmeta[0], t0=t_enq,
                                dur=agg_s, task=tmeta[0], similarity=sim)
            data = Data(name, content=comp.result,
                        meta={"reuse": "en", "similarity": sim,
                              "en": en.prefix, "window_agg": True})
            self._send_from_en(node, data,
                               max(comp.t_done - self._now, 0.0))

        leader_fut.add_done_callback(deliver)

    def _store_ready(self, node: Any, name: str, done: float, result: Any,
                     meta: Dict[str, Any], resolved: bool = True,
                     service: str = "") -> _ReadyEntry:
        """Register a TTC-protocol deferred result with a TTL expiry guard.

        Entries used to be popped only by an on-time fetch, so tasks whose
        users never fetched (or crashed mid-early-fetch-loop) leaked forever;
        the timer expires the entry ``en_ready_ttl_s`` after completion.
        Unresolved (engine-backed, still executing) entries arm their timer
        at resolution instead (``_resolve_ready``)."""
        entry = _ReadyEntry(done, result, meta, resolved=resolved,
                            service=service)
        key = (node, name)
        old = self._en_ready.get(key)
        if old is not None and old.timer is not None:
            old.timer.cancel()
        self._en_ready[key] = entry
        if resolved:
            entry.timer = self.at(done + self.en_ready_ttl_s,
                                  self._expire_ready, key, entry)
        return entry

    def _resolve_ready(self, key: Tuple[Any, str], entry: _ReadyEntry,
                       fut: Future) -> None:
        """Engine completion for a TTC-protocol task: fill the ready entry
        (result, exact completion time, backend reuse attribution) and arm
        its TTL guard; the user's scheduled fetch delivers from it."""
        if self._en_ready.get(key) is not entry:
            return  # TTL-expired or superseded before completion
        if fut.exception is not None:
            # execution aborted (engine torn down / offload dead-ended):
            # drop the entry so the user's fetch is NACKed and re-expresses
            # the task instead of waiting out a TTC that will never land.
            self._en_ready.pop(key, None)
            en = (self.edge_nodes.get(key[0]) or self._departed.get(key[0])
                  or self._crashed.get(key[0]))
            if en is not None:
                en.stats.inc("exec_failed")
            return
        comp = fut.result
        entry.done = comp.t_done
        entry.result = comp.result
        entry.resolved = True
        meta = dict(entry.meta)
        if comp.reuse is not None:
            meta["reuse"] = comp.reuse
            meta["similarity"] = comp.similarity
            meta["reuse_node"] = comp.remote_en or \
                f"{self._en_of(key[0]).prefix}/replica/{comp.replica}"
        if comp.remote_en:
            meta["fed_en"] = comp.remote_en
        if comp.stale_owner:
            meta["stale_owner"] = True
        if comp.backup:
            meta["backup"] = True
        entry.meta = meta
        entry.timer = self.at(comp.t_done + self.en_ready_ttl_s,
                              self._expire_ready, key, entry)

    def _deliver_completion(self, node: Any, name: str, fwd_err: bool,
                            fut: Future) -> None:
        """Direct protocol: the backend's result exists — answer the task
        Interest through the EN's forwarder at ``t_done`` (immediately when
        the future resolved at completion time, i.e. the engine path).
        A rejected future (``ExecAborted``) answers with a NACK instead so
        downstream PIT state unwinds and consumers re-express promptly."""
        if fut.exception is not None:
            en = (self.edge_nodes.get(node) or self._departed.get(node)
                  or self._crashed.get(node))
            if en is not None:
                en.stats.inc("exec_failed")
            if node in self._crashed:
                if self._san is not None:
                    self._san.note_loss(
                        name, f"execution died at crashed {node!r}")
                return  # the EN app died with the work; silence
            self._send_nack(node, name, str(fut.exception))
            return
        comp = fut.result
        en = self._en_of(node)
        meta = {"reuse": comp.reuse, "en": en.prefix, "fwd_error": fwd_err}
        if comp.reuse is not None:
            meta["similarity"] = comp.similarity
            meta["reuse_node"] = comp.remote_en or \
                f"{en.prefix}/replica/{comp.replica}"
        if comp.remote_en:
            meta["fed_en"] = comp.remote_en
        if comp.stale_owner:
            meta["stale_owner"] = True
        if comp.backup:
            meta["backup"] = True
        data = Data(name, content=comp.result, meta=meta)
        self._send_from_en(node, data, max(comp.t_done - self._now, 0.0))

    def _expire_ready(self, key: Tuple[Any, str], entry: _ReadyEntry) -> None:
        if self._en_ready.get(key) is entry:
            self._en_ready.pop(key, None)
            self._en_of(key[0]).stats.inc("ready_expired")

    def _en_fetch(self, node: Any, interest: Interest) -> None:
        """Deferred result fetch at an EN (paper Fig. 3b, second exchange)."""
        en = self._en_of(node)
        orig = interest.name[len(en.prefix):]
        entry = self._en_ready.get((node, orig))
        if entry is None:
            # unsolicited or expired: answer with a NACK (was a silent drop)
            # so the consumer re-expresses the task instead of timing out.
            en.stats.inc("fetch_drops")
            self._send_nack(node, interest.name, "no-ready-entry")
            return
        en.stats.inc("fetches")
        if entry.resolved and entry.done <= self._now + 1e-9:
            self._en_ready.pop((node, orig), None)
            if entry.timer is not None:
                entry.timer.cancel()
            data = Data(interest.name, content=entry.result,
                        meta=dict(entry.meta))
            self._send_from_en(node, data, 0.0)
        else:  # early fetch: respond with an updated TTC (paper §IV-C)
            en.stats.inc("early_fetches")
            ttc = (entry.done - self._now if entry.resolved
                   else self._backend_ttc(node, orig, entry))
            data = Data(interest.name,
                        content={"ttc": ttc, "en_prefix": en.prefix},
                        meta={"control": "ttc", "cacheable": False,
                              "en": en.prefix})
            self._send_from_en(node, data, 0.0)

    def _backend_ttc(self, node: Any, name: str, entry: _ReadyEntry) -> float:
        """TTC refresh for a still-executing (engine-backed) task."""
        if entry.service:
            return max(self.backend.ttc_estimate(node, entry.service), 1e-4)
        return max(entry.done - self._now, 1e-4)

    def _send_nack(self, node: Any, name: str, reason: str) -> None:
        """Application-level NACK: a non-cacheable Data naming a dead-end
        exchange (aborted execution, expired ready entry), so downstream PIT
        state unwinds and the consumer re-expresses immediately instead of
        waiting out its retransmission timer."""
        if node in self._crashed:
            if self._san is not None:
                self._san.note_loss(name, f"NACK died at crashed {node!r}")
            return
        en = self.edge_nodes.get(node) or self._departed.get(node)
        self.fault_stats.inc("nacks_sent")
        if self._tracer is not None:
            tmeta = self._task_meta.get(name)
            if tmeta is not None:
                self._tracer.instant("nack", "retx", tmeta[0], task=tmeta[0],
                                     reason=reason, node=str(node))
        data = Data(name, content=None,
                    meta={"control": "nack", "reason": reason,
                          "cacheable": False,
                          "en": en.prefix if en is not None else ""})
        self._send_from_en(node, data, 0.0)

    def _send_from_en(self, node: Any, data: Data, delay: float) -> None:
        fwd = self.forwarders[node]

        def emit():
            if node in self._crashed:
                # the result died with the EN (in-flight at crash time)
                self.fault_stats.inc("crash_drops")
                if self._san is not None:
                    self._san.note_loss(data.name,
                                        f"result died at crashed {node!r}")
                return
            actions = fwd.on_data(data, APP_FACE, self._now)
            self._emit(node, actions, self._now)

        self.at(self._now + delay, emit)

    def _oracle_other_en_hit(self, node: Any, svc: str, emb, threshold: float) -> bool:
        """Forwarding-error oracle (Fig. 10): could another EN have reused?

        One batched ``query_batch`` peek per other EN — pure read: no LRU
        refresh, no query/candidate statistics (``peek=True``).
        """
        q = normalize(np.asarray(emb, np.float32).reshape(-1))[None]
        for other, en in self.edge_nodes.items():
            if other == node:
                continue
            store = en.stores[svc]
            if not len(store):
                continue
            (_, _, idx), = store.query_batch(q, threshold, peek=True)
            if idx is not None:
                return True
        return False

    # ------------------------------------------------------------ client API
    def submit_task(
        self,
        user_id: str,
        service: str,
        x: np.ndarray,
        threshold: float = 0.8,
        at_time: Optional[float] = None,
        input_size: int = 0,
    ) -> TaskRecord:
        """Schedule a task offload; returns its (live) TaskRecord."""
        svc = self.services[service.strip("/")]
        node, fwd = self.users[user_id]
        emb = normalize(np.asarray(x, np.float32).reshape(-1))
        t0 = self._now if at_time is None else at_time
        rec = TaskRecord(
            next(self._task_ids), user_id, service, "", t0,
            true_result=svc.execute(emb),
        )
        self.metrics.records.append(rec)

        def start():
            hint = None
            if self.mode == "reservoir":
                buckets = self.lsh.hash_one(emb)
                name = make_task_name(service, buckets, self.lsh_params.index_size_bytes)
                hash_t = self.delays.hash_time_s(self.lsh_params.num_tables)
            else:
                # ICedge: name carries coarse app semantics; the application's
                # adaptive forwarding strategy picks the EN from the tag.
                tag = icedge_tag(emb, self.icedge_tag_bits)
                name = f"/{service.strip('/')}/ictask/{tag}"
                hash_t = 10e-6  # cheap semantic-name construction
                # crc32, not hash(): str hash() is process-salted, which made
                # seeded icedge runs route to different ENs per process
                en_node = self.en_nodes[
                    zlib.crc32(tag.encode()) % len(self.en_nodes)]
                hint = self.edge_nodes[en_node].prefix
            rec.name = name
            tr = self._tracer
            sid = None
            if tr is not None:
                tr.name_task(rec.task_id, f"task {rec.task_id}")
                sid = tr.begin("task", "task", rec.task_id, t=t0,
                               user=user_id, service=service, task_name=name)
            tmeta = [rec.task_id, t0, sid]
            self._task_meta[name] = tmeta
            # Send time of the latest Interest for this task.  The RTT that
            # schedules the Fig. 3b result fetch must be measured from it:
            # measuring from t_submit (the old behaviour) folds the whole
            # elapsed TTC wait into the "RTT" on every re-fetch round, so the
            # estimate grew each round and the fetch wait collapsed toward 0
            # (fetch spam) instead of tracking the actual interest RTT.
            sent_at = [t0]
            # --- consumer retransmission (DESIGN.md §Fault model): one timer
            # guards the outstanding exchange ("task" Interest or TTC result
            # "fetch"); any response cancels it, a timeout re-expresses the
            # Interest with a fresh nonce + retx flag under exponential
            # backoff.  tries is cumulative across the task's exchanges.
            # Disabled (the lossless-fabric default) this adds no events.
            state = {"tries": 0, "timer": None, "phase": "task",
                     "fetch": None, "task_cb": False, "fetch_cb": None}

            def cancel_timer():
                if state["timer"] is not None:
                    state["timer"].cancel()
                    state["timer"] = None

            def arm(phase):
                if self.retx_timeout_s <= 0:
                    return
                cancel_timer()
                timeout = self.retx_timeout_s * (
                    self.retx_backoff ** state["tries"])
                state["timer"] = self.at(self._now + timeout, on_timeout,
                                         phase, state["tries"])

            def finish_trace(outcome: str, **args):
                """Close the task's span and drop its name-map entries."""
                if tr is not None and tmeta[2] is not None:
                    tr.end(tmeta[2], outcome=outcome, retx=rec.retx, **args)
                    tmeta[2] = None
                self._task_meta.pop(name, None)
                if state["fetch"] is not None:
                    self._task_meta.pop(state["fetch"], None)

            def give_up():
                rec.failed = True
                finish_trace("failed")
                self.fault_stats.inc("retx_give_ups")
                if self._san is not None:
                    # the abandoned exchange may leave its task / fetch name
                    # pending in PITs forever; that is the designed outcome
                    self._san.note_loss(name, "consumer retx give-up")
                    if state["fetch"] is not None:
                        self._san.note_loss(state["fetch"],
                                            "consumer retx give-up")

            def retransmit():
                """Re-express the original task Interest (fresh nonce, retx
                flag).  Uniform recovery for every lost exchange: a live EN
                coalesces the re-expression onto its in-flight/ready state
                (refreshed TTC or store hit), and if the owner died the
                re-partitioned rFIB routes it to the new one — retrying a
                result-*fetch* name could only ever reach the dead prefix."""
                if state["tries"] >= self.retx_max:
                    give_up()
                    return
                state["tries"] += 1
                rec.retx += 1
                self.fault_stats.inc("retx_sent")
                if tr is not None:
                    tr.instant("retx", "retx", rec.task_id,
                               task=rec.task_id, attempt=state["tries"])
                state["phase"] = "task"
                state["fetch"] = None
                send_task()
                arm("task")

            def on_timeout(phase, seen_tries):
                state["timer"] = None
                if rec.t_complete >= 0 or rec.failed:
                    return
                if state["phase"] != phase or state["tries"] != seen_tries:
                    return  # the exchange moved on; stale timer
                retransmit()

            def on_task_response(data: Data, t: float):
                state["task_cb"] = False
                on_result(data, t)

            def on_fetch_response(data: Data, t: float):
                state["fetch_cb"] = None
                on_result(data, t)

            def send_task():
                if self.federator is not None:
                    # heartbeat for the failure detector: hits and
                    # retransmissions are traffic too, not just misses
                    self.federator.note_activity()
                interest = Interest(
                    name,
                    app_params={
                        "service": service.strip("/"),
                        "input": emb,
                        "threshold": threshold,
                        "user_prefix": fwd.node_id,
                        "input_size": input_size,
                    },
                    forwarding_hint=hint,
                    retx=state["tries"],
                )
                state["phase"] = "task"
                if not state["task_cb"]:
                    self._pending_cb.setdefault(
                        (node, name), []).append(on_task_response)
                    state["task_cb"] = True
                actions = fwd.on_interest(interest, APP_FACE, self._now)
                if state["tries"] == 0:
                    # the input is hashed once; retries reuse the name
                    for a in actions:
                        a.delay_s += hash_t
                self._emit(node, actions, self._now)

            def send_fetch(fetch_name, retx: Optional[int] = None):
                if fetch_name is None:
                    return
                sent_at[0] = self._now
                state["phase"] = "fetch"
                state["fetch"] = fetch_name
                if state["fetch_cb"] != fetch_name:
                    self._pending_cb.setdefault(
                        (node, fetch_name), []).append(on_fetch_response)
                    state["fetch_cb"] = fetch_name
                actions = fwd.on_interest(
                    Interest(fetch_name,
                             retx=state["tries"] if retx is None else retx),
                    APP_FACE, self._now)
                self._emit(node, actions, self._now)

            def on_result(data: Data, t: float):
                if rec.t_complete >= 0 or rec.failed:
                    return
                if data.meta.get("control") == "nack":
                    # the exchange dead-ended at the EN (aborted execution,
                    # lost ready entry): re-express the original task — the
                    # (possibly re-partitioned) rFIB picks the owner afresh.
                    self.fault_stats.inc("nacks_received")
                    if tr is not None:
                        tr.instant("nack-received", "retx", rec.task_id,
                                   task=rec.task_id,
                                   reason=data.meta.get("reason", ""))
                    cancel_timer()
                    state["phase"] = "task"
                    state["fetch"] = None
                    if self.retx_timeout_s > 0:
                        retransmit()
                    else:
                        give_up()
                    return
                if data.meta.get("control") == "ttc":
                    # Fig. 3b: schedule the result fetch at TTC - RTT
                    cancel_timer()
                    rtt = max(t - sent_at[0], 1e-4)
                    wait = max(float(data.content["ttc"]) - rtt, 0.0)
                    fetch_name = data.content["en_prefix"] + name
                    state["phase"] = "fetch"
                    state["fetch"] = fetch_name
                    # fetch Interests carry the same task: alias the name so
                    # hop attribution (and drain-close) follows the exchange
                    self._task_meta[fetch_name] = tmeta
                    if tr is not None:
                        tr.instant("ttc-answer", "ttc", rec.task_id,
                                   task=rec.task_id,
                                   ttc=float(data.content["ttc"]))

                    def fetch():
                        if rec.t_complete >= 0 or rec.failed:
                            return
                        # Carry the task's retx count: if an earlier fetch for
                        # this name was lost in flight, the consumer's own PIT
                        # still holds a pending entry and a fresh-nonce fetch
                        # would be aggregated into it (black-holed); the retx
                        # flag forces the "retransmit" verdict so every hop
                        # re-forwards past the stale entry.
                        send_fetch(fetch_name)
                        arm("fetch")

                    self.at(t + wait, fetch)
                    return
                cancel_timer()
                rec.t_complete = t
                rec.result = data.content
                reuse = data.meta.get("reuse")
                if reuse == "cs":
                    rnode = data.meta.get("reuse_node", "")
                    rec.reuse = "user" if rnode == fwd.node_id else "cs"
                    rec.reuse_node = rnode
                else:
                    rec.reuse = reuse
                    # a federated completion reports the EN that actually
                    # answered (fed_en), not the EN the rFIB routed to
                    rec.reuse_node = (data.meta.get("fed_en")
                                      or data.meta.get("en"))
                rec.remote_en = data.meta.get("fed_en")
                rec.stale_owner = bool(data.meta.get("stale_owner", False))
                rec.similarity = float(data.meta.get("similarity", -1.0))
                rec.aggregated = bool(data.meta.get("window_agg", False))
                rec.forwarding_error = bool(data.meta.get("fwd_error", False))
                if rec.reuse is not None:
                    rec.correct = results_match(rec.result, rec.true_result)
                finish_trace("completed", reuse=rec.reuse or "scratch",
                             reuse_node=rec.reuse_node)

            # The completion callback fires when Data reaches this user's
            # APP_FACE (via the PIT return path).
            send_task()
            arm("task")
            self._pit_sweep.kick()

        self.at(t0, start)
        return rec

    # --------------------------------------------------------------- helpers
    def flush_events(self) -> None:
        self.loop.clear()


def results_match(a: Any, b: Any) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b


_ICEDGE_PLANES: Dict[Tuple[int, int], np.ndarray] = {}


def icedge_tag(emb: np.ndarray, bits: int = 4) -> str:
    """ICedge-style coarse semantic tag: sign-quantise a few projections.

    Models 'naming semantics provide limited information about the input'
    (§V-D) — the tag captures coarse context only, so near-duplicates can get
    different tags and different inputs can share one.
    """
    emb = np.asarray(emb, np.float32).reshape(-1)
    key = (bits, emb.shape[0])
    planes = _ICEDGE_PLANES.get(key)
    if planes is None:
        rng = np.random.default_rng(0x1CED)
        planes = rng.standard_normal((bits, emb.shape[0])).astype(np.float32)
        _ICEDGE_PLANES[key] = planes
    code = (planes @ emb > 0).astype(int)
    return "".join(map(str, code))
