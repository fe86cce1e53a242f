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

``EngineBackend``, the ``ComputeBackend`` that puts these engines behind a
``ReservoirNetwork``'s edge nodes, comes with the simulator slice: every
caller and test of it goes through the network.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.edge_node import ExecAborted, _ewma_service_s
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
