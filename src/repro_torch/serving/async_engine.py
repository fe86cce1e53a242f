"""Event-driven serving core: futures + deadline batching + straggler backup.

Port of ``repro/serving/async_engine.py``.  Reservoir's edge nodes are
inherently asynchronous — Interests arrive continuously, identical
in-flight tasks aggregate in the PIT, results fan back out on completion —
and this engine expresses that on the shared virtual-clock event loop
(``core/sim_clock.py``):

* **Futures in, futures out** — ``submit`` returns a ``Future`` resolved
  with a ``ServeResult``; ``drain``/``run`` advance the loop.
* **Deadline-aware batching** — admitted requests queue per
  ``(replica, service)`` in the ``Batcher``; one flush timer per queue fires
  at ``Batcher.due_at`` (head wait or inherited ``deadline_s`` pressure),
  and each flush drives one ``handle_batch``-equivalent pipeline pass built
  from ``ReplicaEngine``'s composable stages.
* **True PIT coalescing** — an identical in-flight name attaches the new
  request as a *follower* on the leader's future; followers resolve the
  moment the leader's result exists (exact-name reuse at sim 1.0) and
  record their aggregation wait, instead of being re-handled.
* **TTC-based straggler re-dispatch** — every executed group arms one
  backup timer per task at ``BackupPolicy.backup_delay_s`` (factor x TTC,
  paper §IV-C); a firing timer re-dispatches the task to the next replica,
  whichever completion comes first wins the future (``try_set_result``),
  the loser's commit is skipped (no double insert), the winner back-fills
  the primary replica's Content Store, and ``BackupPolicy.cancel`` tears
  down the remaining timers.

Execution latency is *virtual*: ``exec_time_fn(replica_id, service, reqs)``
supplies the simulated duration of a batch (straggler injection lives
there); when absent, the measured wall time of ``execute_fn`` is used, so
real-model runs keep physical timing.  The sync ``ServingFleet.submit`` /
``submit_batch`` APIs are thin wrappers over this engine with a drained
loop (``engine.py``), which is what makes scalar parity testable.

The engine runs on the card by default: its router hashes each admitted
request with the ``lsh_hash_mix`` kernel (one launch and one host read of
the (T,) buckets per request, as the reference's one hash dispatch each),
and ``device`` must be the replicas' device.  Everything on the clock is
Python floats and the reference's draws: no torch scalar touches a time.

``EngineBackend`` puts these engines behind a ``ReservoirNetwork``'s edge
nodes (the co-simulation): every replica and engine on the network's device.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.edge_node import (
    ComputeBackend,
    ExecAborted,
    ExecCompletion,
    LoadSnapshot,
    _ewma_service_s,
)
from ..core.lsh import LSHParams, normalize
from ..core.packets import Data
from ..core.sim_clock import EventLoop, Future, Timer
from ..device import DeviceLike
from ..obs.registry import CounterGroup
from ..training.elastic import BackupPolicy
from .batcher import Batcher
from .engine import ReplicaEngine, ReuseRouter, ServeRequest, ServeResult


@dataclasses.dataclass
class _Task:
    """One in-flight leader (async PIT entry)."""

    req: ServeRequest
    name: str
    emb: np.ndarray                # normalized (D,)
    buckets: np.ndarray            # (T,) LSH buckets from admission
    t_arrival: float
    future: Future
    primary: int
    service: str
    followers: List[Tuple[ServeRequest, float, Future]] = dataclasses.field(
        default_factory=list)
    dispatched: List[int] = dataclasses.field(default_factory=list)
    backups_sent: int = 0

    @property
    def key(self) -> Tuple[int, str]:
        return (self.primary, self.name)


class AsyncServingEngine:
    """Router + replicas + batcher + PIT futures + backup timers, one loop."""

    def __init__(
        self,
        lsh_params: LSHParams,
        replicas: List[ReplicaEngine],
        backup: Optional[BackupPolicy] = None,
        loop: Optional[EventLoop] = None,
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        exec_time_fn: Optional[
            Callable[[int, str, List[ServeRequest]], float]] = None,
        bucket_range: Optional[Tuple[int, int]] = None,
        device: DeviceLike = None,
    ):
        # NOT ``loop or EventLoop()``: EventLoop.__len__ makes an *empty*
        # loop falsy, which silently discarded a shared (not-yet-populated)
        # loop and broke co-scheduling with the network simulator.
        self.loop = loop if loop is not None else EventLoop()
        self.router = ReuseRouter(lsh_params, len(replicas),
                                  bucket_range=bucket_range, device=device)
        # the router's buckets name tasks on the replicas: one device
        mismatched = [r.replica_id for r in replicas
                      if r.device != self.router.lsh.device]
        if mismatched:
            raise ValueError(
                f"replicas {mismatched} are not on the engine's device "
                f"{self.router.lsh.device}")
        self.replicas = replicas
        self.backup = backup or BackupPolicy()
        self.batcher = Batcher(max_batch=max_batch, max_wait_s=max_wait_s)
        self.exec_time_fn = exec_time_fn
        self._inflight: Dict[Tuple[int, str], _Task] = {}
        self._queued: Dict[int, _Task] = {}  # id(req) -> task while batched
        self._flush_timers: Dict[Tuple[int, str], Timer] = {}
        self.engine_stats = CounterGroup(
            {"backups": 0, "backup_wins": 0, "dispatches": 0})

    # --------------------------------------------------------------- submit
    def submit(self, req: ServeRequest) -> Future:
        """Admit a request at the current virtual time; returns its Future."""
        fut = Future()
        self._admit(req, fut)
        return fut

    def submit_at(self, t: float, req: ServeRequest) -> Future:
        """Schedule a request arrival at virtual time ``t`` (trace replay)."""
        fut = Future()
        self.loop.at(t, self._admit, req, fut)
        return fut

    def _admit(self, req: ServeRequest, fut: Future) -> None:
        t = self.loop.now
        rid, buckets = self.router.route(req.embedding)  # one hash dispatch
        rep = self.replicas[rid]
        name = rep.name_of(req.service, buckets)

        # 1. Content Store: exact-name reuse resolves immediately
        content = rep.cs_lookup(name, t)
        if content is not None:
            fut.try_set_result(
                ServeResult(req.request_id, content, "cs", 1.0, 0.0, rid),
                now=t)
            return
        # 2. PIT coalescing: attach as follower on the leader's future
        task = self._inflight.get((rid, name))
        if task is not None:
            rep.stats.inc("aggregated")
            task.followers.append((req, t, fut))
            return
        # 3. new leader: register in-flight, queue for a batched flush
        emb = normalize(np.asarray(req.embedding, np.float32).reshape(-1))
        task = _Task(req, name, emb, np.asarray(buckets), t, fut, rid,
                     req.service)
        self._inflight[(rid, name)] = task
        self._queued[id(req)] = task
        key = (rid, req.service)
        full = self.batcher.add(req, t, key=key)
        if full is not None:
            self._dispatch(rid, req.service, self._tasks_of(full), t)
        self._sync_flush_timer(key)

    def _tasks_of(self, reqs: List[ServeRequest]) -> List[_Task]:
        return [self._queued.pop(id(r)) for r in reqs]

    # ------------------------------------------------------------- batching
    def _sync_flush_timer(self, key: Tuple[int, str]) -> None:
        """One timer per queue, parked at the queue's next due time."""
        due = self.batcher.due_at(key)
        timer = self._flush_timers.get(key)
        if due is None:
            if timer is not None:
                timer.cancel()
                self._flush_timers.pop(key, None)
            return
        due = max(due, self.loop.now)
        if timer is not None and not timer.cancelled and timer.when <= due:
            return
        if timer is not None:
            timer.cancel()
        self._flush_timers[key] = self.loop.at(due, self._on_flush, key)

    def _on_flush(self, key: Tuple[int, str]) -> None:
        self._flush_timers.pop(key, None)
        rid, service = key
        if self.batcher.pending(key):
            reqs = self.batcher.flush(key, self.loop.now)
            self._dispatch(rid, service, self._tasks_of(reqs), self.loop.now)
        self._sync_flush_timer(key)

    # ------------------------------------------------------------- pipeline
    def _dispatch(self, exec_rid: int, service: str, tasks: List[_Task],
                  t: float) -> None:
        """One pipeline pass on ``exec_rid``: batched EN query, then execute
        the misses as one model batch with a deferred completion event."""
        tasks = [task for task in tasks if not task.future.done]
        if not tasks:
            return
        rep = self.replicas[exec_rid]
        self.engine_stats.inc("dispatches")
        tr = self.loop.tracer
        for task in tasks:
            task.dispatched.append(exec_rid)
            if tr is not None and task.req.trace_tid is not None:
                tr.instant("engine-dispatch", "engine", task.req.trace_tid,
                           replica=exec_rid, task=task.req.trace_tid)
        embs = np.stack([task.emb for task in tasks])
        thrs = np.asarray([task.req.threshold for task in tasks], np.float32)
        out = rep.query_reuse(service, embs, thrs)
        missed: List[_Task] = []
        for task, (result, sim, idx) in zip(tasks, out):
            if idx is not None:
                rep.admit_en_hit(task.name, result, t)
                is_backup = exec_rid != task.primary
                if is_backup:
                    # cross-replica semantic rescue: the backup replica's
                    # store answered instantly — back-fill the primary's CS
                    # and count the win like an executed backup
                    self.replicas[task.primary].cs.insert(
                        Data(task.name, content=result), t)
                    self.engine_stats.inc("backup_wins")
                    if tr is not None and task.req.trace_tid is not None:
                        tr.instant("backup-win", "engine",
                                   task.req.trace_tid, replica=exec_rid,
                                   task=task.req.trace_tid, reuse="en")
                self._resolve(task, result, "en", sim, exec_rid, t,
                              backup=is_backup)
            else:
                missed.append(task)
        if not missed:
            return
        outs, wall = rep.execute_batch([task.req for task in missed])
        duration = (wall if self.exec_time_fn is None else
                    self.exec_time_fn(exec_rid, service,
                                      [task.req for task in missed]))
        self.loop.at(t + duration, self._complete, exec_rid, service,
                     missed, outs, duration)
        # Arm straggler timers only once the TTC estimator has real
        # observations for this service: the uninformed prior would turn
        # every cold start (e.g. a first-dispatch jit compile on the wall-
        # time path) into a spurious duplicate execution.
        if rep.ttc.informed(service):
            ttc = rep.ttc.estimate(service)
            for task in missed:
                delay = self.backup.backup_delay_s(ttc, task.backups_sent)
                if (delay is not None
                        and len(task.dispatched) < len(self.replicas)):
                    timer = self.loop.at(t + delay, self._fire_backup, task)
                    self.backup.arm(task.key, timer.cancel)

    def _complete(self, exec_rid: int, service: str, tasks: List[_Task],
                  outs: List[Any], duration: float) -> None:
        """Execution finished (virtual time): commit + resolve the survivors.

        Tasks already resolved by a faster backup/primary race are skipped
        entirely — their results are discarded without touching the store or
        the CS, so a task is inserted exactly once fleet-wide."""
        t = self.loop.now
        live = [(task, res) for task, res in zip(tasks, outs)
                if not task.future.done]
        if not live:
            return
        rep = self.replicas[exec_rid]
        rep.commit_execution(
            service, np.stack([task.emb for task, _ in live]),
            [task.name for task, _ in live], [res for _, res in live],
            t, duration * len(live) / len(tasks),
            buckets=np.stack([task.buckets for task, _ in live]))
        for task, res in live:
            is_backup = exec_rid != task.primary
            if is_backup:
                # cross-replica CS back-fill: the primary learns the named
                # result too, so retries routed there hit its Content Store
                self.replicas[task.primary].cs.insert(
                    Data(task.name, content=res), t)
                self.engine_stats.inc("backup_wins")
                tr = self.loop.tracer
                if tr is not None and task.req.trace_tid is not None:
                    tr.instant("backup-win", "engine", task.req.trace_tid,
                               replica=exec_rid, task=task.req.trace_tid,
                               reuse="scratch")
            self._resolve(task, res, None, -1.0, exec_rid, t,
                          backup=is_backup)

    def _resolve(self, task: _Task, result: Any, reuse: Optional[str],
                 sim: float, exec_rid: int, t: float,
                 backup: bool = False) -> bool:
        """First-result-wins resolution of a leader and all its followers."""
        won = task.future.try_set_result(
            ServeResult(task.req.request_id, result, reuse, sim,
                        t - task.t_arrival, exec_rid, backup=backup), now=t)
        if not won:
            return False
        for freq, ft, ffut in task.followers:
            ffut.try_set_result(
                ServeResult(freq.request_id, result, "cs", 1.0, t - ft,
                            exec_rid, agg_wait_s=t - ft, backup=backup),
                now=t)
        self._inflight.pop(task.key, None)
        self.backup.cancel(task.key)
        return True

    # ------------------------------------------------------------ stragglers
    def _fire_backup(self, task: _Task) -> None:
        """TTC deadline exceeded: re-dispatch to the next untried replica."""
        if task.future.done:  # safety net; resolution cancels these timers
            return
        n = len(self.replicas)
        candidates = [r for r in range(n) if r not in task.dispatched]
        if not candidates:
            return
        rid = min(candidates,
                  key=lambda r: (r - task.primary) % n)  # next ring neighbour
        task.backups_sent += 1
        self.engine_stats.inc("backups")
        tr = self.loop.tracer
        if tr is not None and task.req.trace_tid is not None:
            tr.instant("backup", "engine", task.req.trace_tid,
                       replica=rid, attempt=task.backups_sent,
                       task=task.req.trace_tid)
        self._dispatch(rid, task.service, [task], self.loop.now)

    # ------------------------------------------------------------ crash-stop
    def abort_all(self, exc: Optional[BaseException] = None) -> None:
        """Crash-stop teardown: reject every in-flight future with ``exc``.

        Pending batches never execute, armed flush/backup timers are torn
        down, and leader + follower futures fail with the exception — which
        ``Future`` error propagation carries to whoever awaited them (the
        network layer NACKs or drops on the EN's behalf).  The engine is
        unusable afterwards; the caller must also stop admitting."""
        exc = exc or ExecAborted("serving engine aborted")
        now = self.loop.now
        for timer in self._flush_timers.values():
            timer.cancel()
        self._flush_timers.clear()
        self.batcher.queues.clear()
        self._queued.clear()
        for task in list(self._inflight.values()):
            self.backup.cancel(task.key)
            # designed race: an execution event already on the loop may
            # still try to resolve these after the abort settles them
            task.future.allow_late()
            task.future.try_set_exception(exc, now=now)
            for _, _, ffut in task.followers:
                ffut.allow_late()
                ffut.try_set_exception(exc, now=now)
        self._inflight.clear()

    # -------------------------------------------------------------- running
    def drain(self, until: float = float("inf")) -> float:
        """Run the loop until idle (or ``until``); returns the clock."""
        return self.loop.run(until)

    def pending(self) -> int:
        return len(self._inflight)

    def load(self) -> Tuple[float, float]:
        """Load telemetry: (in-flight leader depth, EWMA service time).

        The federation layer gossips this between ENs (DESIGN.md
        §Federation).  Depth counts every unresolved leader — batcher-queued
        and executing alike — which is exactly the backlog an arriving task
        queues behind; followers ride leaders so they add no work."""
        ewma = float(np.mean([_ewma_service_s(r.ttc) for r in self.replicas]))
        return float(len(self._inflight)), ewma

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = dict(self.engine_stats)
        for r in self.replicas:
            for k, v in r.stats.items():
                out[k] = out.get(k, 0) + v
        return out


# ------------------------------------------------------------------- co-sim
class EngineBackend(ComputeBackend):
    """``ComputeBackend`` (core/edge_node.py seam) backed by per-EN
    ``AsyncServingEngine`` replica sets on the *network's* event loop.

    This is the co-simulation seam: a ``ReservoirNetwork`` EN whose reuse
    store missed
    submits the task into its attached serving engine instead of sampling an
    inline delay.  Forwarding and execution then share one timeline —

    * the EN's batch window flushes admit one ``ServeRequest`` per miss at
      ``now + lead_delay_s`` (the LSH search / input pull precede the
      accelerator queue); the engine's own deadline-aware ``Batcher``
      re-batches them per (replica, service),
    * queueing, batching, replica-store reuse, PIT coalescing, and
      TTC-driven straggler backups all run as engine events on the shared
      clock, and every resolution — including a backup's win — propagates
      back as a network-visible NDN completion,
    * Fig. 3b TTC answers come from the engines' ``TTCEstimator``s
      (EWMA-informed once real executions exist) plus the batcher window,
      not from an omniscient ``done - now``.

    Executed results are also inserted into the EN's own reuse store at
    completion time, so network-edge reuse (and cross-EN forwarding-error
    accounting) keeps working exactly as with the inline model.  Virtual
    execution time defaults to the service's calibrated ``exec_time_s``
    sample with sub-linear batch amortisation (``len(batch) **
    batch_alpha``), overridable via ``exec_time_fn`` for straggler
    injection.

    Every replica and engine lives on the network's device (``attach``):
    their stores, the routers' hash and the EN stores share one card."""

    def __init__(
        self,
        n_replicas: int = 2,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        backup: Optional[BackupPolicy] = None,
        batch_alpha: float = 0.5,
        exec_time_fn: Optional[
            Callable[[int, str, List[ServeRequest]], float]] = None,
        replica_store_capacity: int = 100_000,
        replica_cs_capacity: int = 4096,
        wall_time: bool = False,
        replicas_per_en: Optional[Dict[Any, int]] = None,
        seed: int = 0,
    ):
        # heterogeneous fleets: per-EN replica counts (node -> count)
        # override the global ``n_replicas`` default — a beefy metro EN can
        # run 4 replicas while a closet EN runs 1, and the federation
        # layer's least-loaded/affinity policies see the difference through
        # ``load_snapshot``'s ``workers`` field.
        self.replicas_per_en = dict(replicas_per_en or {})
        self.n_replicas = n_replicas
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.backup = backup
        self.batch_alpha = batch_alpha
        self.exec_time_fn = exec_time_fn
        self.replica_store_capacity = replica_store_capacity
        self.replica_cs_capacity = replica_cs_capacity
        # wall_time: charge the *measured* wall duration of execute_fn as
        # the virtual batch duration (real-model-behind-simulated-network
        # mode) instead of sampling the service's calibrated exec_time_s
        self.wall_time = wall_time
        self.seed = seed
        self.net = None
        self.engines: Dict[Any, AsyncServingEngine] = {}
        self._ids = itertools.count()

    # ------------------------------------------------------------ wiring
    def attach(self, network) -> None:
        self.net = network
        self.engines = {}
        n_ens = len(network.en_nodes)
        nb = network.lsh_params.effective_buckets
        unknown = set(self.replicas_per_en) - set(network.en_nodes)
        if unknown:
            raise ValueError(f"replicas_per_en names unknown ENs: {unknown}")
        for idx, node in enumerate(network.en_nodes):
            node_seed = self.seed + zlib.crc32(str(node).encode()) % 9973
            n_rep = self.replicas_per_en.get(node, self.n_replicas)
            if n_rep < 1:
                raise ValueError(f"EN {node!r} needs >= 1 replica")
            replicas = [
                ReplicaEngine(
                    i, network.lsh_params, self._execute,
                    cs_capacity=self.replica_cs_capacity,
                    store_capacity=self.replica_store_capacity,
                    device=network.device)
                for i in range(n_rep)
            ]
            # Each EN's replica router partitions the EN's *own* rFIB bucket
            # subrange (the same consecutive split core.rfib.partition
            # installs, in en_nodes order).  Re-partitioning the full space
            # would be the nested-partition pathology: the network already
            # localized this EN's tasks to one slice, so every task would
            # land on a single replica regardless of the replica count.
            bucket_range = (round(idx * nb / n_ens),
                            round((idx + 1) * nb / n_ens))
            self.engines[node] = AsyncServingEngine(
                network.lsh_params, replicas,
                backup=self.backup or BackupPolicy(),
                loop=network.loop, max_batch=self.max_batch,
                max_wait_s=self.max_wait_s,
                exec_time_fn=None if self.wall_time else (
                    self.exec_time_fn or self._virtual_exec_time(
                        random.Random(node_seed))),
                bucket_range=bucket_range, device=network.device,
            )
            self._adopt_stats(node, self.engines[node])

    def _adopt_stats(self, node, engine: AsyncServingEngine) -> None:
        """Re-home this EN's engine + replica counters onto the network's
        metrics registry (gossip-cadence snapshots pick them up)."""
        reg = getattr(self.net, "registry", None)
        if reg is None:
            return
        reg.adopt(f"engine/{node}", engine.engine_stats)
        for rep in engine.replicas:
            reg.adopt(f"engine/{node}/r{rep.replica_id}", rep.stats)

    def _execute(self, reqs: List[ServeRequest]) -> List[Any]:
        """Replica execute_fn: run the registered edge service on each
        payload (the task's input embedding, exactly as the inline model)."""
        return [self.net.services[r.service].execute(
            np.asarray(r.payload, np.float32)) for r in reqs]

    def _virtual_exec_time(self, rng: random.Random):
        """Virtual batch duration: one calibrated per-request sample with
        sub-linear amortisation — the model batch shares prefill work."""

        def fn(rid: int, service: str, reqs: List[ServeRequest]) -> float:
            per_req = self.net.services[service].sample_exec_time(rng)
            return per_req * max(1.0, len(reqs)) ** self.batch_alpha

        return fn

    # ------------------------------------------------------------ seam API
    def submit(self, node, svc_name, interest, emb, lead_delay_s,
               defer_inserts=None) -> Future:
        net = self.net
        engine = self.engines[node]
        tmeta = net._task_meta.get(interest.name)
        req = ServeRequest(
            next(self._ids), svc_name, emb, payload=emb,
            threshold=float(interest.app_params.get("threshold", 0.0)),
            deadline_s=interest.app_params.get("deadline"),
            trace_tid=None if tmeta is None else tmeta[0])
        out = Future()

        def adapt(sr: ServeResult) -> ExecCompletion:
            # ServeResult -> ExecCompletion vocabulary mapping, running at
            # the engine's completion instant (Future.then inherits it).
            # _en_of: a departed EN's in-flight executions drain gracefully.
            t = net.loop.now
            en = net._en_of(node)
            net.registry.observe_phase("execute", sr.latency_s)
            tr = net._tracer
            if tr is not None and req.trace_tid is not None:
                tr.complete("execute", "execute", req.trace_tid,
                            t0=t - sr.latency_s, dur=sr.latency_s,
                            task=req.trace_tid, node=str(node),
                            backend="engine", replica=sr.replica,
                            reuse=sr.reuse or "scratch", backup=sr.backup)
            if sr.reuse is None:
                # a real scratch execution: the network-edge reuse store
                # learns the result at the moment it exists on the engine
                en.stats.inc("executed")
                en.stores[svc_name].insert(emb, sr.result)
            return ExecCompletion(sr.result, t, reuse=sr.reuse,
                                  similarity=sr.similarity,
                                  replica=sr.replica, backup=sr.backup)

        def admit() -> None:
            if self.engines.get(node) is not engine:
                # EN crashed during the lead delay: its engine is gone, the
                # task dies with it (the consumer's retransmission or the
                # federator's offload timeout recovers it elsewhere)
                out.try_set_exception(
                    ExecAborted(f"EN {node!r} crashed before admit"))
                return
            engine.submit(req).then(adapt).add_done_callback(
                lambda f: f.propagate(out))

        if lead_delay_s > 0:
            net.loop.call_later(lead_delay_s, admit)
        else:
            admit()
        return out

    def ttc_estimate(self, node, svc_name) -> float:
        """Fig. 3b TTC answer while the engine still runs: the replicas'
        EWMA service-time estimate plus one batcher flush window."""
        engine = self.engines[node]
        est = float(np.mean([r.ttc.estimate(svc_name)
                             for r in engine.replicas]))
        return est + engine.batcher.max_wait_s

    def load_snapshot(self, node, now) -> LoadSnapshot:
        """Engine queue telemetry for the federation gossip: in-flight
        leaders across this EN's replica set, with the replica count as the
        parallelism the expected-wait estimate divides by."""
        engine = self.engines[node]
        depth, service_s = engine.load()
        return LoadSnapshot(node, now, depth=depth, service_s=service_s,
                            workers=len(engine.replicas))

    def on_partition_change(self) -> None:
        """Follow an rFIB re-partition (federation rebalance / EN leave):
        each EN's replica router re-splits the EN's *new* bucket slice.
        Without this, a shifted partition leaves the router's stale span
        behind and every task clamps onto one edge replica — the
        nested-partition pathology coming back through the side door.
        Slices come from the first service's entries; ``partition``/
        ``rebalance`` install identical per-EN ranges for every service."""
        net = self.net
        if net is None or not net.services or not net.en_nodes:
            return
        entries = net.forwarders[net.en_nodes[0]].rfib.entries(
            next(iter(net.services)))
        for node, engine in self.engines.items():
            en = net.edge_nodes.get(node)
            if en is None:
                continue  # departed: engine only drains, no new arrivals
            mine = [e for e in entries if e.en_prefix == en.prefix]
            if mine:
                lo = min(e.ranges[0][0] for e in mine)
                hi = max(e.ranges[0][1] for e in mine) + 1
            else:
                # starved out of the partition entirely (extreme weights
                # round its range empty): no affinity structure remains, so
                # split the FULL space — keeping the stale span would clamp
                # offloaded tasks onto one edge replica
                lo, hi = 0, net.lsh_params.effective_buckets
            engine.router.bucket_range = (lo, hi)
            engine.router.rescale(len(engine.replicas))

    def on_en_join(self, node) -> None:
        """EN join (``ReservoirNetwork.add_en``): spin up an engine for the
        newcomer, seeded/configured exactly as ``attach`` would have.  The
        replica router starts on the full bucket space; the
        ``on_partition_change`` that follows the join's re-partition narrows
        it to the EN's real rFIB slice."""
        if self.net is None or node in self.engines:
            return
        node_seed = self.seed + zlib.crc32(str(node).encode()) % 9973
        n_rep = self.replicas_per_en.get(node, self.n_replicas)
        if n_rep < 1:
            raise ValueError(f"EN {node!r} needs >= 1 replica")
        replicas = [
            ReplicaEngine(
                i, self.net.lsh_params, self._execute,
                cs_capacity=self.replica_cs_capacity,
                store_capacity=self.replica_store_capacity,
                device=self.net.device)
            for i in range(n_rep)
        ]
        self.engines[node] = AsyncServingEngine(
            self.net.lsh_params, replicas,
            backup=self.backup or BackupPolicy(),
            loop=self.net.loop, max_batch=self.max_batch,
            max_wait_s=self.max_wait_s,
            exec_time_fn=None if self.wall_time else (
                self.exec_time_fn or self._virtual_exec_time(
                    random.Random(node_seed))),
            bucket_range=(0, self.net.lsh_params.effective_buckets),
            device=self.net.device,
        )
        self._adopt_stats(node, self.engines[node])

    def on_en_crash(self, node) -> None:
        """Crash-stop (``ReservoirNetwork.crash_en``): the EN's engine dies
        with it — queued batches are lost, in-flight futures fail with
        ``ExecAborted`` (no graceful drain, unlike an announced leave where
        the departed engine keeps running until its work completes)."""
        engine = self.engines.pop(node, None)
        if engine is not None:
            engine.abort_all(ExecAborted(f"EN {node!r} crashed"))

    # ------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, int]:
        """Engine counters aggregated across all ENs' replica sets."""
        out: Dict[str, int] = {}
        for engine in self.engines.values():
            for k, v in engine.stats().items():
                out[k] = out.get(k, 0) + v
        return out
