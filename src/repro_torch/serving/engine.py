"""Reuse-aware serving engine: Reservoir semantics in front of real models.

Port of ``repro/serving/engine.py`` (``ServeRequest``, ``ServeResult``,
``ReplicaEngine``, ``ReuseRouter``, and ``ServingFleet``, the sync facade
over ``async_engine.AsyncServingEngine``).  A request's input embedding is
LSH-hashed (the ``lsh_hash_mix`` CUDA kernel on the card); the resulting
*task name* drives, in order:

  1. exact-name result cache   == NDN Content Store (CS) hit,
  2. in-flight coalescing      == PIT aggregation,
  3. semantic reuse            == EN nearest-neighbour + threshold,
  4. bucket-range routing      == rFIB: which replica serves the request,
  5. execution from scratch    == the model's prefill/decode serve path,
     result stored for future reuse, TTC statistics updated.

The engine is replica-local (one per DP shard group); the bucket->replica
partition is the same consecutive-range scheme as core.rfib and re-splits on
elastic events (training/elastic.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.content_store import ContentStore
from ..core.edge_node import TTCEstimator
from ..core.lsh import LSHParams, get_lsh, normalize
from ..core.namespace import make_task_name
from ..core.packets import Data
from ..core.reuse_store import ReuseStore
from ..device import DeviceLike, resolve_device
from ..obs import trace as _trace
from ..obs.registry import CounterGroup
from ..training.elastic import BackupPolicy


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    service: str
    embedding: np.ndarray          # input embedding (LSH key space)
    payload: Any = None            # model inputs (tokens, ...)
    threshold: float = 0.9
    deadline_s: Optional[float] = None
    trace_tid: Optional[int] = None   # originating task's trace track


@dataclasses.dataclass
class ServeResult:
    request_id: int
    result: Any
    reuse: Optional[str]           # 'cs' | 'en' | None
    similarity: float
    latency_s: float
    replica: int
    agg_wait_s: float = 0.0        # time spent PIT-aggregated behind a leader
    backup: bool = False           # resolved by a straggler backup dispatch


class ReplicaEngine:
    """One serving replica: semantic cache + model executor."""

    def __init__(self, replica_id: int, lsh_params: LSHParams,
                 execute_fn: Callable[[List[ServeRequest]], List[Any]],
                 cs_capacity: int = 4096, store_capacity: int = 100_000,
                 device: DeviceLike = None):
        self.replica_id = replica_id
        self.device = resolve_device(device)
        self.lsh = get_lsh(lsh_params, self.device)
        self.params = lsh_params
        self.execute_fn = execute_fn
        self.cs = ContentStore(cs_capacity)
        self.store_capacity = store_capacity
        self.stores: Dict[str, ReuseStore] = {}
        self.ttc = TTCEstimator()
        self.lsh_params = lsh_params
        self.inflight: Dict[str, List[ServeRequest]] = {}
        self.stats = CounterGroup({"cs": 0, "en": 0, "executed": 0, "aggregated": 0})

    def _store(self, service: str) -> ReuseStore:
        if service not in self.stores:
            # was hardcoded to 100_000, silently ignoring the ctor argument
            self.stores[service] = ReuseStore(
                self.params, capacity=self.store_capacity, device=self.device)
        return self.stores[service]

    # -------------------------------------------------- composable stages
    # The serving pipeline is split into stages shared verbatim by the sync
    # paths below and by serving.async_engine.AsyncServingEngine: name/CS
    # resolution, batched EN query, execution, and result commit.  Stages
    # own the statistics they touch, so sync and async runs of the same
    # trace produce identical counters.

    def embed_batch(self, reqs: List[ServeRequest]
                    ) -> Tuple[np.ndarray, List[str], np.ndarray]:
        """One LSH hash launch for the batch -> (embs, names, buckets).

        The (B, T) buckets ride along so a later ``commit_execution`` can
        insert without re-hashing the same embeddings."""
        with _trace.span("replica.name"):
            embs = normalize(np.stack(
                [np.asarray(r.embedding, np.float32).reshape(-1) for r in reqs]))
            buckets = self.lsh.hash_batch(embs).cpu().numpy()  # (B, T)
            names = [make_task_name(r.service, b, self.params.index_size_bytes)
                     for r, b in zip(reqs, buckets)]
        return embs, names, buckets

    def name_of(self, service: str, buckets: np.ndarray) -> str:
        """Task name from pre-computed LSH buckets (router reuse: no rehash)."""
        return make_task_name(service, buckets, self.params.index_size_bytes)

    def cs_lookup(self, name: str, now: float) -> Optional[Any]:
        """Stage 1: exact-name Content Store hit (counts the hit)."""
        hit = self.cs.lookup(name, now)
        if hit is None:
            return None
        self.stats.inc("cs")
        return hit.content

    def query_reuse(self, service: str, embs: np.ndarray,
                    thresholds: np.ndarray) -> List[Tuple[Any, float, Optional[int]]]:
        """Stage 3: one batched semantic-reuse query for a service group."""
        return self._store(service).query_batch(embs, thresholds)

    def admit_en_hit(self, name: str, result: Any, now: float) -> None:
        """Record an EN hit: count it and cache the named result in the CS."""
        self.stats.inc("en")
        self.cs.insert(Data(name, content=result), now)

    def execute_batch(self, reqs: List[ServeRequest]) -> Tuple[List[Any], float]:
        """Stage 4a: run the model on a miss group -> (results, wall seconds)."""
        # lint: disable=D002(real model execution wall time, by design)
        t_exec = time.perf_counter()
        with _trace.span("replica.exec") as sp:
            if sp:
                sp.note(tasks=len(reqs))
            outs = self.execute_fn(reqs)
        # lint: disable=D002(real model execution wall time, by design)
        return outs, time.perf_counter() - t_exec

    def commit_execution(self, service: str, embs: np.ndarray,
                         names: List[str], outs: List[Any], now: float,
                         exec_time_s: float,
                         buckets: Optional[np.ndarray] = None) -> None:
        """Stage 4b: bulk-insert executed results into the reuse store + CS,
        update TTC with the amortized per-request time, count executions.

        Split from ``execute_batch`` so the async engine can defer the commit
        to the (virtual) completion event — and skip it entirely when a
        backup already resolved the task (no double insert).  ``buckets``
        reuses the admission-time hash for the store insert."""
        with _trace.span("replica.commit"):
            store = self._store(service)
            store.insert_batch(embs, outs, buckets=buckets)
            # Page the fresh embeddings onto the device now, off the query
            # critical path: the next query_batch starts without an upload
            # stall.  No-op until the store's kernel path has gone
            # device-resident.
            store.sync_device()
            # amortized per-request time, matching the scalar path's
            # batch-of-1 observations (maybe_backup compares a *single*
            # request's elapsed time against this EWMA)
            self.ttc.observe(service, exec_time_s / max(len(outs), 1))
            with _trace.span("replica.cs"):
                for name, result in zip(names, outs):
                    self.cs.insert(Data(name, content=result), now)
                    self.stats.inc("executed")

    # ------------------------------------------------------------ sync paths
    def handle(self, req: ServeRequest, now: Optional[float] = None) -> Optional[ServeResult]:
        """Serve one request; returns None if coalesced behind an identical
        in-flight task (resolved when the executing request completes).

        ``now`` sets the Content-Store clock (pass the virtual loop time
        when the replica is shared with an async engine so freshness
        decisions come from one clock); latency is always wall-measured."""
        # lint: disable=D002(serve latency is wall-measured by design)
        t0 = time.perf_counter()
        t_cs = t0 if now is None else now
        emb = normalize(np.asarray(req.embedding, np.float32).reshape(-1))
        buckets = self.lsh.hash_one(emb)
        name = self.name_of(req.service, buckets)

        # 1. Content Store (exact LSH-name reuse)
        content = self.cs_lookup(name, t_cs)
        if content is not None:
            return ServeResult(req.request_id, content, "cs", 1.0,
                               # lint: disable=D002(wall latency, by design)
                               time.perf_counter() - t0, self.replica_id)
        # 2. PIT-style aggregation of identical in-flight names
        if name in self.inflight:
            self.inflight[name].append(req)
            self.stats.inc("aggregated")
            return None
        # 3. EN semantic reuse
        store = self._store(req.service)
        result, sim, idx = store.query(emb, req.threshold)
        if idx is not None:
            self.admit_en_hit(name, result, t_cs)
            return ServeResult(req.request_id, result, "en", sim,
                               # lint: disable=D002(wall latency, by design)
                               time.perf_counter() - t0, self.replica_id)
        # 4. execute from scratch
        self.inflight[name] = [req]
        outs, exec_time = self.execute_batch([req])
        self.commit_execution(req.service, emb[None], [name], outs, t_cs,
                              exec_time, buckets=np.asarray(buckets)[None])
        self.inflight.pop(name, None)
        return ServeResult(req.request_id, outs[0], None, sim,
                           # lint: disable=D002(wall latency, by design)
                           time.perf_counter() - t0, self.replica_id)

    def handle_batch(self, reqs: List[ServeRequest],
                     now: Optional[float] = None) -> List[ServeResult]:
        """Batched ``handle``: one LSH hash launch + one semantic-reuse
        query per service for the whole batch.

        Stage order per request matches the scalar path (CS -> aggregation ->
        EN reuse -> execute), with within-batch PIT aggregation resolved
        synchronously: followers of an identical in-flight name receive the
        leader's executed result.  Misses are executed in one ``execute_fn``
        call per service and bulk-inserted.  ``now`` sets the Content-Store
        clock (see ``handle``); latency is always wall-measured.  The call
        is a ``replica.handle`` span of the wall recorder (``obs.trace``).
        """
        if not reqs:
            return []
        with _trace.span("replica.handle") as sp:
            if sp:
                sp.note(replica=self.replica_id, tasks=len(reqs))
            return self._handle_batch(reqs, now)

    def _handle_batch(self, reqs: List[ServeRequest],
                      now: Optional[float]) -> List[ServeResult]:
        # lint: disable=D002(serve latency is wall-measured by design)
        t0 = time.perf_counter()
        t_cs = t0 if now is None else now
        embs, names, buckets = self.embed_batch(reqs)
        results: List[Optional[ServeResult]] = [None] * len(reqs)

        def _done(i: int, result: Any, reuse: Optional[str], sim: float):
            results[i] = ServeResult(reqs[i].request_id, result, reuse, sim,
                                     # lint: disable=D002(wall latency, by design)
                                     time.perf_counter() - t0, self.replica_id)

        # --- CS hits + within-batch coalescing
        leaders: Dict[str, int] = {}
        followers: Dict[int, int] = {}  # follower index -> leader index
        pending: List[int] = []
        with _trace.span("replica.cs"):
            for i, name in enumerate(names):
                content = self.cs_lookup(name, t_cs)
                if content is not None:
                    _done(i, content, "cs", 1.0)
                    continue
                if name in leaders:
                    self.stats.inc("aggregated")
                    followers[i] = leaders[name]
                    continue
                leaders[name] = i
                pending.append(i)

        # --- one batched semantic-reuse query per service
        by_service: Dict[str, List[int]] = {}
        for i in pending:
            by_service.setdefault(reqs[i].service, []).append(i)
        missed: Dict[str, List[int]] = {}
        for service, idxs in by_service.items():
            out = self.query_reuse(
                service, embs[idxs],
                np.asarray([reqs[i].threshold for i in idxs], np.float32))
            with _trace.span("replica.cs"):
                for i, (result, sim, idx) in zip(idxs, out):
                    if idx is not None:
                        self.admit_en_hit(names[i], result, t_cs)
                        _done(i, result, "en", sim)
                    else:
                        missed.setdefault(service, []).append(i)

        # --- execute misses (one model batch per service) + bulk insert
        for service, idxs in missed.items():
            outs, exec_time = self.execute_batch([reqs[i] for i in idxs])
            self.commit_execution(service, embs[idxs], [names[i] for i in idxs],
                                  outs, t_cs, exec_time, buckets=buckets[idxs])
            for i, result in zip(idxs, outs):
                _done(i, result, None, -1.0)

        # --- resolve within-batch aggregated followers: identical task name
        # == exact reuse, and the leader (executed or en-hit) has inserted the
        # name into the CS by now, so the scalar-equivalent re-handle is
        # always a CS hit at sim 1.0.  A follower "arrived" at t0 with its
        # leader and resolved the moment the leader did — it inherits the
        # leader's completion timestamp (not the end of the whole batch) and
        # records the interval it spent aggregated as agg_wait_s.
        for i, leader in followers.items():
            lead = results[leader]
            results[i] = ServeResult(
                reqs[i].request_id, lead.result, "cs", 1.0, lead.latency_s,
                self.replica_id, agg_wait_s=lead.latency_s)
        return results


class ReuseRouter:
    """rFIB-equivalent: consecutive LSH bucket ranges -> replica ids.

    ``bucket_range`` restricts the partitioned span to ``[lo, hi)`` instead
    of the full ``effective_buckets``.  This matters when the router sits
    *behind* another range partition (edge co-sim: the network's rFIB
    already sliced the bucket space across ENs, so a per-EN replica set that
    re-partitions the full space would map every local task onto a single
    replica — the nested-partition pathology).  Buckets outside the span
    clamp to the nearest edge replica."""

    def __init__(self, lsh_params: LSHParams, n_replicas: int,
                 bucket_range: Optional[Tuple[int, int]] = None,
                 device: DeviceLike = None):
        self.params = lsh_params
        self.lsh = get_lsh(lsh_params, device)
        self.n_replicas = n_replicas
        self.bucket_range = bucket_range or (0, lsh_params.effective_buckets)
        self._bounds = self._make_bounds(n_replicas)

    def _make_bounds(self, n: int) -> List[int]:
        lo, hi = self.bucket_range
        return [lo + round(i * (hi - lo) / n) for i in range(n + 1)]

    def rescale(self, n_replicas: int) -> None:
        """Elastic event: re-partition ranges (consistent, consecutive)."""
        self.n_replicas = n_replicas
        self._bounds = self._make_bounds(n_replicas)

    def _owner(self, bucket: int) -> int:
        if bucket < self._bounds[0]:
            return 0
        for i in range(self.n_replicas):
            if self._bounds[i] <= bucket < self._bounds[i + 1]:
                return i
        return self.n_replicas - 1

    def route(self, embedding: np.ndarray) -> Tuple[int, np.ndarray]:
        """Majority vote over per-table bucket owners (paper §IV-D)."""
        emb = normalize(np.asarray(embedding, np.float32).reshape(-1))
        buckets = self.lsh.hash_one(emb)
        votes: Dict[int, int] = {}
        for b in buckets:
            o = self._owner(int(b))
            votes[o] = votes.get(o, 0) + 1
        return max(votes.items(), key=lambda kv: (kv[1], -kv[0]))[0], buckets

    def route_batch(self, embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``route``: one hash launch, (B,) owners + (B, T) buckets.

        Owner lookup is a searchsorted over the consecutive range bounds; the
        majority vote is a one-hot count with ties broken toward the smallest
        replica id (same as the scalar path).
        """
        with _trace.span("router.route"):
            embs = normalize(np.atleast_2d(np.asarray(embeddings, np.float32)))
            buckets = self.lsh.hash_batch(embs).cpu().numpy()          # (B, T)
            bounds = np.asarray(self._bounds[1:-1])
            owners = np.searchsorted(bounds, buckets, side="right")    # (B, T)
            owners = np.minimum(owners, self.n_replicas - 1)
            votes = (owners[:, :, None] == np.arange(self.n_replicas)[None, None, :]
                     ).sum(axis=1)                                     # (B, R)
            return votes.argmax(axis=1), buckets


class ServingFleet:
    """Router + replicas + straggler mitigation, sync facade.

    ``submit``/``submit_batch`` are thin wrappers over the event-driven
    ``AsyncServingEngine`` (serving/async_engine.py): requests are admitted
    as futures and the virtual-clock loop is drained to completion, so the
    sync API exercises exactly the async pipeline (batcher flush, PIT
    follower futures, backup timers) — which is what makes scalar parity
    against ``handle_batch`` testable.  ``submit_batch_sync`` keeps the
    direct one-``handle_batch``-per-replica path as the parity reference.
    """

    def __init__(self, lsh_params: LSHParams, replicas: List[ReplicaEngine],
                 backup: Optional[BackupPolicy] = None,
                 max_batch: int = 8, max_wait_s: float = 0.005,
                 device: DeviceLike = None):
        from .async_engine import AsyncServingEngine  # avoid import cycle

        self.engine = AsyncServingEngine(
            lsh_params, replicas, backup=backup,
            max_batch=max_batch, max_wait_s=max_wait_s, device=device)
        self.router = self.engine.router
        self.replicas = replicas
        self.backup = self.engine.backup

    def submit(self, req: ServeRequest) -> ServeResult:
        fut = self.engine.submit(req)
        self.engine.drain()
        return fut.result

    def submit_batch(self, reqs: List[ServeRequest]) -> List[ServeResult]:
        """Admit a whole batch at one virtual instant, drain, and return
        results in submission order."""
        futs = [self.engine.submit(r) for r in reqs]
        self.engine.drain()
        return [f.result for f in futs]

    def submit_batch_sync(self, reqs: List[ServeRequest]) -> List[ServeResult]:
        """Direct sync path: route a whole batch (one hash dispatch), then
        one ``handle_batch`` per replica; results in submission order.

        Passes the engine's virtual time as the Content-Store clock so the
        replicas' CS state stays on ONE clock even when both facade paths
        are mixed on the same fleet (wall timestamps would instantly expire
        entries inserted at virtual time, and vice versa).

        The call is the ``fleet.submit`` span of the wall recorder, which
        it arms while ``torch.profiler`` records (``obs.trace``)."""
        if not reqs:
            return []
        _trace.follow_profiler()
        with _trace.span("fleet.submit") as sp:
            if sp:
                sp.note(tasks=len(reqs))
            owners, _ = self.router.route_batch(
                np.stack([np.asarray(r.embedding, np.float32).reshape(-1)
                          for r in reqs]))
            results: List[Optional[ServeResult]] = [None] * len(reqs)
            for rid in sorted(set(int(o) for o in owners)):
                idxs = [i for i, o in enumerate(owners) if int(o) == rid]
                for i, res in zip(idxs, self.replicas[rid].handle_batch(
                        [reqs[i] for i in idxs], now=self.engine.loop.now)):
                    results[i] = res
            return results

    def maybe_backup(self, elapsed_s: float, service: str, primary: int,
                     backups_sent: int = 0) -> Optional[int]:
        """Straggler mitigation: pick a backup replica when TTC is exceeded."""
        ttc = self.replicas[primary].ttc.estimate(service)
        if self.backup.should_backup(elapsed_s, ttc, backups_sent):
            return (primary + 1) % len(self.replicas)
        return None

    def stats(self) -> Dict[str, int]:
        """Fleet-wide counters: replica stats + the engine's backup/dispatch
        counters (backups can fire during a drained ``submit``)."""
        return self.engine.stats()
