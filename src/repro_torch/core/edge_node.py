"""Edge Node (EN): service execution, reuse store, TTC estimation (§IV-C/E).

Port of ``repro/core/edge_node.py``.  An EN offers a set of *services*.  A
received task is first matched against the reuse store; on a hit whose
similarity clears the task's threshold the stored result is returned (reuse
at the EN).  Otherwise the task is executed from scratch, its result stored,
and — per the paper's offloading protocol (Fig. 3b/3c) — the EN returns a
Time-To-Completion estimate so the user can fetch the result right when it
is ready, plus a pull of large inputs.

TTC is estimated from per-service execution statistics (EWMA) plus the
current queue backlog, matching "ENs maintain statistics about the execution
of the services over time".

An ``EdgeNode``'s reuse stores live on its ``device`` (None: the CUDA card,
where a store scores with the ``gather_top1`` kernel; ``device="cpu"`` for
the plain versions).  The compute seam (``ComputeBackend``) has two
implementations: ``InlineBackend`` here, and
``serving.async_engine.EngineBackend``.
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs.registry import CounterGroup
from .lsh import LSHParams
from .namespace import parse_task_name
from .packets import Data, Interest
from .reuse_store import ReuseStore
from .sim_clock import Future


class ExecAborted(RuntimeError):
    """Execution abandoned before a result existed — the owning EN crashed,
    a serving engine was torn down mid-flight, or a delegated offload timed
    out with no path left to re-dispatch.  Set on the execution ``Future``
    (``try_set_exception``) so waiters are rejected deterministically
    instead of dangling past drain-to-idle."""


@dataclasses.dataclass
class Service:
    """An edge service: ``execute`` is the from-scratch path.

    ``execute(input) -> result``; ``exec_time_s`` may be a constant or a
    (lo, hi) range sampled per execution (the paper's TF models: 70–100 ms).
    """

    name: str
    execute: Callable[[np.ndarray], Any]
    exec_time_s: Any = (0.070, 0.100)
    input_dim: int = 64
    kind: str = "classification"  # or "generation", "embedding"

    def sample_exec_time(self, rng: random.Random) -> float:
        if isinstance(self.exec_time_s, (int, float)):
            return float(self.exec_time_s)
        lo, hi = self.exec_time_s
        return rng.uniform(lo, hi)


class TTCEstimator:
    """EWMA service time + queue backlog -> time-to-completion estimate."""

    def __init__(self, alpha: float = 0.2, initial_s: float = 0.085):
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.initial = initial_s

    def observe(self, service: str, exec_time: float) -> None:
        prev = self.ewma.get(service, exec_time)
        self.ewma[service] = (1 - self.alpha) * prev + self.alpha * exec_time

    def informed(self, service: str) -> bool:
        """True once real executions back the estimate (vs the prior)."""
        return service in self.ewma

    def estimate(self, service: str, queue_len: int = 0) -> float:
        base = self.ewma.get(service, self.initial)
        return base * (1 + queue_len)


# ------------------------------------------------------------ compute seam
@dataclasses.dataclass
class ExecCompletion:
    """Resolution payload of a ``ComputeBackend`` execution future.

    ``t_done`` is the absolute virtual time the result exists at the EN —
    the network schedules the ``Data``/TTC exchange from it.  ``reuse`` /
    ``similarity`` report *backend-side* reuse (a serving replica's Content
    Store or semantic store answered instead of the model); the inline
    delay-sampled backend always executes, so it leaves them at the scratch
    defaults."""

    result: Any
    t_done: float
    reuse: Optional[str] = None        # 'cs' | 'en' | None (executed)
    similarity: float = -1.0
    replica: Optional[int] = None      # engine replica that produced it
    backup: bool = False               # a straggler backup won the race
    remote_en: Optional[str] = None    # federated: prefix of the EN that
                                       # actually answered (offloaded miss)
    stale_owner: bool = False          # the answering EN no longer owns the
                                       # task's buckets (store hit served off
                                       # a pre-rebalance resident — migration
                                       # should have moved it)


class ComputeBackend:
    """Seam between an EN's network-side task treatment and its execution.

    The network decides *whether* a task must execute (reuse-store miss) and
    owns the NDN protocol exchange; the backend decides *when the result
    exists* and what produced it.  ``submit`` admits one scratch task and
    returns a ``Future`` resolving with an ``ExecCompletion`` — no earlier
    than virtual time ``t_done``:

    * ``InlineBackend``  — the simulator's classic delay-sampled model
      (calibrated exec-time sample + EN busy-queue); resolves synchronously.
    * ``serving.async_engine.EngineBackend`` — submits into a per-EN
      ``AsyncServingEngine`` replica set sharing the network's event loop;
      resolves when the engine's (batched, backup-raced) completion event
      fires.
    """

    def attach(self, network) -> None:
        """Bind to a ``ReservoirNetwork`` (loop, ENs, services)."""
        raise NotImplementedError

    def submit(self, node: Any, svc_name: str, interest: Interest,
               emb: np.ndarray, lead_delay_s: float,
               defer_inserts: Optional[List[Tuple[np.ndarray, Any]]] = None,
               ) -> Future:
        """Admit one scratch execution; ``lead_delay_s`` is EN-side work
        (LSH search + input pull) that precedes execution."""
        raise NotImplementedError

    def ttc_estimate(self, node: Any, svc_name: str) -> float:
        """Fig. 3b TTC answer for a task whose future is still pending."""
        raise NotImplementedError

    def load_snapshot(self, node: Any, now: float) -> "LoadSnapshot":
        """Execution-side load telemetry for one EN (federation seam).

        ``depth`` counts tasks queued or executing behind this EN's compute,
        ``service_s`` is the EWMA per-task service time, ``workers`` the
        parallel execution lanes — enough for a remote EN to estimate the
        expected wait ``depth * service_s / workers`` when deciding whether
        to offload a miss here (federation/policy.py)."""
        raise NotImplementedError

    def on_partition_change(self) -> None:
        """The network re-partitioned rFIB bucket ownership (rebalance or
        EN leave).  Backends whose internal routing derives from the
        partition (``EngineBackend``'s per-EN replica ``bucket_range``)
        re-derive it here; the inline model has no such state."""

    def on_en_crash(self, node: Any) -> None:
        """Crash-stop (no drain): tear down per-EN execution state and
        reject every in-flight future with ``ExecAborted``.  The inline
        model resolves at submit time, so it has nothing in flight; the
        serving engine backend overrides this to abort its replicas."""

    def on_en_join(self, node: Any) -> None:
        """A new EN joined the fleet (``ReservoirNetwork.add_en``).
        Backends with per-EN execution state (``EngineBackend``'s replica
        engines) create it here; the inline model needs nothing — the
        network initializes its busy-queue accounting itself.  The
        partition-derived state (replica ``bucket_range``) is fixed by the
        ``on_partition_change`` that follows the join's re-partition."""


@dataclasses.dataclass
class LoadSnapshot:
    """Per-EN load telemetry gossiped between ENs (federation layer).

    Snapshots age: ``wait_s(now)`` decays the expected wait by the time
    elapsed since capture — a work-conserving queue observed ``depth`` deep
    at ``t`` has drained ``now - t`` seconds of work since (assuming no new
    arrivals, which is exactly the staleness a gossip interval buys)."""

    node: Any
    t: float                 # virtual capture time
    depth: float             # tasks queued or executing
    service_s: float         # EWMA per-task service time
    workers: int = 1         # parallel execution lanes (engine replicas)

    def wait_s(self, now: Optional[float] = None) -> float:
        wait = self.depth * self.service_s / max(self.workers, 1)
        if now is not None:
            wait -= max(now - self.t, 0.0)
        return max(wait, 0.0)


def _ewma_service_s(ttc: TTCEstimator, service: Optional[str] = None) -> float:
    """Mean informed EWMA service time (the prior when uninformed)."""
    if service is not None and ttc.informed(service):
        return ttc.ewma[service]
    if ttc.ewma:
        return float(sum(ttc.ewma.values()) / len(ttc.ewma))
    return ttc.initial


class InlineBackend(ComputeBackend):
    """Exact-parity inline execution: the pre-seam delay-sampled model.

    Draws the exec-time sample from the *network's* RNG in the legacy order
    and keeps busy-queue accounting in ``net._en_busy_until``, so a seeded
    trace reproduces the pre-refactor ``Metrics.summary()`` bit-for-bit."""

    def __init__(self):
        self.net = None

    def attach(self, network) -> None:
        self.net = network

    def submit(self, node, svc_name, interest, emb, lead_delay_s,
               defer_inserts=None) -> Future:
        net = self.net
        en = net.edge_nodes[node]
        svc = net.services[svc_name]
        exec_t = svc.sample_exec_time(net._rng) * net.exec_inflation(node)
        result = svc.execute(emb)
        if defer_inserts is None:
            en.stores[svc_name].insert(emb, result)
        else:
            defer_inserts.append((emb, result))
        en.stats.inc("executed")
        en.ttc.observe(svc_name, exec_t)
        start = max(net.loop.now + lead_delay_s, net._en_busy_until[node])
        done = start + exec_t
        net._en_busy_until[node] = done
        net.registry.observe_phase("execute", exec_t)
        tr = net._tracer
        if tr is not None:
            tmeta = net._task_meta.get(interest.name)
            if tmeta is not None:
                tr.complete("execute", "execute", tmeta[0], t0=start,
                            dur=exec_t, task=tmeta[0], node=str(node),
                            backend="inline")
        fut = Future()
        fut.set_result(ExecCompletion(result, done), now=net.loop.now)
        return fut

    def ttc_estimate(self, node, svc_name) -> float:
        # Only reached for *offloaded* pending futures (inline local futures
        # resolve synchronously): the local EWMA is the best a delegating EN
        # can answer before the remote result exists.
        en = self.net._en_of(node)
        return en.ttc.estimate(svc_name)

    def load_snapshot(self, node, now) -> LoadSnapshot:
        """Inline queue telemetry: the busy-until horizon IS the backlog."""
        en = self.net.edge_nodes[node]
        ewma = _ewma_service_s(en.ttc)
        busy = max(self.net._en_busy_until[node] - now, 0.0)
        return LoadSnapshot(node, now, depth=busy / max(ewma, 1e-6),
                            service_s=ewma, workers=1)


@dataclasses.dataclass
class TaskOutcome:
    data: Data
    reused: bool
    similarity: float
    exec_time_s: float  # 0.0 when reused
    store_size: int


class EdgeNode:
    def __init__(
        self,
        prefix: str,
        lsh_params: LSHParams,
        store_capacity: int = 100_000,
        similarity: str = "cosine",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        # every reuse store of this EN lives on ``device`` (None -> cuda)
        self.device = resolve_device(device)
        self.prefix = prefix.rstrip("/")
        self.lsh_params = lsh_params
        self.services: Dict[str, Service] = {}
        self.stores: Dict[str, ReuseStore] = {}
        self.ttc = TTCEstimator()
        self.store_capacity = store_capacity
        self.similarity = similarity
        self.queue_len = 0
        self._rng = random.Random(seed)
        self.stats = CounterGroup({
            "reused": 0, "executed": 0, "unknown_service": 0,
            # TTC-protocol fetch path (network co-sim, paper Fig. 3b):
            "fetches": 0,        # solicited deferred-result fetch Interests
            "early_fetches": 0,  # fetches answered with an updated TTC
            "fetch_drops": 0,    # unsolicited/expired fetches (were silent)
            "ready_expired": 0,  # TTC results never fetched, TTL-expired
            "window_reuse": 0,   # intra-batch-window follower dedup hits
            # federation layer (federation/federator.py):
            "offloaded": 0,      # local misses forwarded to a remote EN
            "remote_hits": 0,    # federated tasks answered from this store
            "remote_execs": 0,   # federated tasks executed on this EN
            "remote_coalesced": 0,  # federated followers riding a leader
            # store migration (DESIGN.md §Store migration):
            "migrated_out": 0,   # entries extracted and shipped elsewhere
            "migrated_in": 0,    # entries landed here by a migration batch
            "stale_owner_hits": 0,  # store hits served for buckets this EN
                                    # no longer owns (pre-migration window)
            # fault/recovery layer (faults/, PIT aging, retransmission):
            "pit_expired": 0,    # PIT entries aged out at this node
            "retx_coalesced": 0,  # retransmissions deduped onto in-flight work
            "exec_failed": 0,    # executions rejected (ExecAborted -> NACK)
        })

    def register(self, service: Service) -> None:
        name = service.name.strip("/")
        self.services[name] = service
        self.stores[name] = ReuseStore(
            self.lsh_params, capacity=self.store_capacity, similarity=self.similarity,
            device=self.device,
        )

    # ------------------------------------------------------------- task path
    def _parse_task(self, interest: Interest) -> Tuple[Service, str, np.ndarray, float]:
        service_name, kw, _ = parse_task_name(interest.name)
        svc = self.services.get(service_name.strip("/"))
        if svc is None:
            self.stats.inc("unknown_service")
            raise KeyError(f"EN {self.prefix} does not offer {service_name}")
        emb = np.asarray(interest.app_params["input"], np.float32)
        threshold = float(interest.app_params.get("threshold", 0.0))
        return svc, kw, emb, threshold

    def _hit_outcome(self, interest: Interest, svc: Service, result: Any,
                     sim: float) -> TaskOutcome:
        self.stats.inc("reused")
        data = Data(
            interest.name,
            content=result,
            meta={"reuse": "en", "similarity": sim, "en": self.prefix},
        )
        return TaskOutcome(data, True, sim, 0.0, len(self.stores[svc.name.strip("/")]))

    def _exec_outcome(
        self, interest: Interest, svc: Service, kw: str, emb: np.ndarray,
        sim: float, defer_inserts: Optional[List[Tuple[np.ndarray, Any]]] = None,
    ) -> TaskOutcome:
        """Execute from scratch, record stats/TTC, store for future reuse.

        ``defer_inserts`` (batch path): accumulate (emb, result) for one
        ``insert_batch`` by the caller instead of inserting immediately.
        """
        key = svc.name.strip("/")
        exec_time = svc.sample_exec_time(self._rng)
        result = svc.execute(emb)
        self.ttc.observe(key, exec_time)
        if kw == "task":
            if defer_inserts is None:
                self.stores[key].insert(emb, result)
            else:
                defer_inserts.append((emb, result))
        self.stats.inc("executed")
        data = Data(
            interest.name,
            content=result,
            meta={"reuse": None, "en": self.prefix},
        )
        return TaskOutcome(data, False, sim, exec_time, len(self.stores[key]))

    def handle_task(self, interest: Interest, now: float = 0.0) -> TaskOutcome:
        """Full task treatment (reuse check -> execute if needed)."""
        svc, kw, emb, threshold = self._parse_task(interest)
        store = self.stores[svc.name.strip("/")]
        if kw == "task":  # reuse-eligible (opt-out tasks use 'exact')
            result, sim, idx = store.query(emb, threshold)
            if idx is not None:
                return self._hit_outcome(interest, svc, result, sim)
        else:
            sim = -1.0
        return self._exec_outcome(interest, svc, kw, emb, sim)

    def handle_task_batch(self, interests: List[Interest], now: float = 0.0) -> List[TaskOutcome]:
        """Batched task treatment: one ``query_batch`` per service.

        Per-item semantics match ``handle_task`` (shared outcome helpers),
        with two batch-specific rules: (1) every query is matched against the
        store state at batch start — an executed result is only reusable by
        *later* batches; (2) the whole batch is validated up front, so an
        unknown service raises before any task is queried or executed.
        Misses are executed from scratch and bulk-inserted per service.
        """
        outcomes: List[Optional[TaskOutcome]] = [None] * len(interests)
        parsed = [self._parse_task(interest) for interest in interests]
        by_service: Dict[str, List[int]] = defaultdict(list)
        for i, (svc, kw, _, _) in enumerate(parsed):
            if kw == "task":
                by_service[svc.name.strip("/")].append(i)

        # --- one batched reuse query per service
        qres: Dict[int, Tuple[Any, float, Optional[int]]] = {}
        for svc_name, idxs in by_service.items():
            store = self.stores[svc_name]
            embs = np.stack([parsed[i][2] for i in idxs])
            thrs = np.asarray([parsed[i][3] for i in idxs], np.float32)
            for i, res in zip(idxs, store.query_batch(embs, thrs)):
                qres[i] = res

        # --- hits return stored results; misses execute + bulk-insert
        to_insert: Dict[str, List[Tuple[np.ndarray, Any]]] = defaultdict(list)
        for i, interest in enumerate(interests):
            svc, kw, emb, _thr = parsed[i]
            result, sim, idx = qres.get(i, (None, -1.0, None))
            if idx is not None:
                outcomes[i] = self._hit_outcome(interest, svc, result, sim)
            else:
                outcomes[i] = self._exec_outcome(
                    interest, svc, kw, emb, sim,
                    defer_inserts=to_insert[svc.name.strip("/")])
        for svc_name, items in to_insert.items():
            if items:
                self.stores[svc_name].insert_batch(
                    np.stack([e for e, _ in items]), [r for _, r in items])
        for i, (svc, kw, _, _) in enumerate(parsed):  # post-insert sizes
            if kw == "task" and not outcomes[i].reused:
                outcomes[i].store_size = len(self.stores[svc.name.strip("/")])
        return outcomes

    def estimate_ttc(self, service: str) -> float:
        return self.ttc.estimate(service.strip("/"), self.queue_len)

    # --------------------------------------------------------- protocol bits
    def make_ttc_response(self, interest: Interest) -> Data:
        """Fig. 3b: no reuse possible -> Data carrying (TTC, EN prefix)."""
        service_name, _, _ = parse_task_name(interest.name)
        return Data(
            interest.name,
            content={"ttc": self.estimate_ttc(service_name), "en_prefix": self.prefix},
            meta={"reuse": None, "control": "ttc", "cacheable": False},
        )

    def result_name(self, interest: Interest) -> str:
        """Name of the deferred result fetch: /<EN-prefix>/<svc>/task/<hash>."""
        return f"{self.prefix}{interest.name}"

    def input_pull_interests(self, interest: Interest, chunk_bytes: int = 8192):
        """Fig. 3c: pull a large input from the user in chunks."""
        size = int(interest.app_params.get("input_size", 0))
        user = interest.app_params.get("user_prefix", "/user")
        nchunks = max(1, -(-size // chunk_bytes))
        return [Interest(f"{user}/input/{interest.nonce}/{i}") for i in range(nchunks)]
