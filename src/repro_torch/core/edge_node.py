"""Edge Node (EN) pieces of the port (from ``repro/core/edge_node.py``).

An EN offers a set of *services*; a task that misses the reuse store is
executed from scratch, its result stored, and a Time-To-Completion estimate
(per-service EWMA execution statistics plus the queue backlog) tells the
user when to fetch it (paper §IV-C, Fig. 3b/3c).

Ported so far: ``Service``, ``TTCEstimator``, and the compute seam that the
async serving engine uses (``ExecAborted``, ``ExecCompletion``,
``ComputeBackend``, ``LoadSnapshot``, ``_ewma_service_s``).  ``EdgeNode``
and ``InlineBackend`` come with the simulator slice.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .packets import Interest
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

    Both implementations come with the port's simulator slice.
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
