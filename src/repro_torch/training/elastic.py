"""Elastic scaling, failure detection, straggler mitigation (control plane).

Port of ``repro/training/elastic.py``: pure Python, identical behaviour.

The mechanisms a 1000+-node deployment needs, implemented as simulatable
control-plane classes (this container has one host; the data plane they
drive — checkpoint restore onto a new mesh, rFIB range re-partitioning —
is fully implemented and tested):

* ``HealthTracker``     — heartbeat bookkeeping, failure + straggler marks
* ``choose_mesh_shape`` — largest (pod, data, model) grid for the survivors
* ``ElasticPlan``       — on shrink/grow: new mesh shape + which Reservoir
  bucket ranges move (consistent consecutive-range re-partition, the same
  primitive the paper's rFIB uses — DESIGN.md §4)
* ``BackupPolicy``      — serving straggler mitigation: send a backup
  request when a task exceeds its TTC-derived deadline (paper §IV-C's TTC
  estimates are exactly what makes this cheap).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


# ------------------------------------------------------------- health tracking
@dataclasses.dataclass
class HostState:
    last_heartbeat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HealthTracker:
    def __init__(self, timeout_s: float = 30.0, straggler_factor: float = 2.0,
                 window: int = 16):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.window = window
        self.hosts: Dict[str, HostState] = {}

    def heartbeat(self, host: str, now: float, step_time: Optional[float] = None):
        st = self.hosts.setdefault(host, HostState())
        st.last_heartbeat = now
        st.alive = True
        if step_time is not None:
            st.step_times.append(step_time)
            st.step_times = st.step_times[-self.window:]

    def failed(self, now: float) -> List[str]:
        out = []
        for host, st in self.hosts.items():
            if st.alive and now - st.last_heartbeat > self.timeout_s:
                st.alive = False
            if not st.alive:
                out.append(host)
        return out

    def stragglers(self) -> List[str]:
        medians = {h: _median(s.step_times) for h, s in self.hosts.items()
                   if s.alive and s.step_times}
        if len(medians) < 2:
            return []
        global_median = _median(sorted(medians.values()))
        return [h for h, m in medians.items()
                if m > self.straggler_factor * global_median]

    def alive_hosts(self, now: float) -> List[str]:
        self.failed(now)
        return sorted(h for h, st in self.hosts.items() if st.alive)


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


# ---------------------------------------------------------------- mesh choice
def choose_mesh_shape(n_devices: int, model_parallel: int = 16,
                      devices_per_pod: int = 256) -> Tuple[int, ...]:
    """Largest usable (pod, data, model) grid for the surviving devices.

    model_parallel is fixed by the parameter sharding; data (and pod) shrink
    to the largest multiple that fits.  Raises if even one model group
    cannot be formed.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}")
    pods = max(1, n_devices // devices_per_pod)
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    if data == 0:
        raise ValueError("not enough devices per pod for one model group")
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


# ---------------------------------------------------------------- elastic plan
@dataclasses.dataclass
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    moved_ranges: List[Tuple[str, Tuple[int, int]]]  # (en_prefix, (lo, hi))

    @property
    def replicas_before(self) -> int:
        return _replicas(self.old_shape)

    @property
    def replicas_after(self) -> int:
        return _replicas(self.new_shape)


def _replicas(shape: Tuple[int, ...]) -> int:
    return shape[0] * shape[1] if len(shape) == 3 else shape[0]


def plan_rescale(old_shape: Tuple[int, ...], n_devices: int,
                 num_buckets: int = 256, model_parallel: int = 16) -> ElasticPlan:
    """Shrink/grow plan: new mesh + which LSH bucket ranges change owner.

    Serving replicas == data-parallel groups == Reservoir ENs; their bucket
    ranges re-partition consistently (only boundary ranges move, matching
    rfib.rebalance) so most of the reuse stores stay warm.
    """
    new_shape = choose_mesh_shape(n_devices, model_parallel)
    rb, ra = _replicas(old_shape), _replicas(new_shape)
    old_bounds = [round(i * num_buckets / rb) for i in range(rb + 1)]
    new_bounds = [round(i * num_buckets / ra) for i in range(ra + 1)]

    def owner(bounds, n, b):
        for j in range(n):
            if bounds[j] <= b < bounds[j + 1]:
                return j
        return n - 1

    # exact per-bucket ownership diff, coalesced into consecutive segments
    moved: List[Tuple[str, Tuple[int, int]]] = []
    seg_start = None
    seg_owner = None
    for b in range(num_buckets):
        o_old, o_new = owner(old_bounds, rb, b), owner(new_bounds, ra, b)
        changed = o_old != o_new
        if changed and seg_start is None:
            seg_start, seg_owner = b, o_new
        elif seg_start is not None and (not changed or o_new != seg_owner):
            moved.append((f"/en/replica{seg_owner}", (seg_start, b - 1)))
            seg_start, seg_owner = (b, o_new) if changed else (None, None)
    if seg_start is not None:
        moved.append((f"/en/replica{seg_owner}", (seg_start, num_buckets - 1)))
    return ElasticPlan(old_shape, new_shape, moved)


# ------------------------------------------------------------ backup requests
@dataclasses.dataclass
class BackupPolicy:
    """Straggler mitigation for serving: duplicate a request to a second
    replica once it exceeds ``factor`` x its TTC estimate.

    Besides the polling-style ``should_backup`` check, the policy carries the
    event-driven serving engine's timer lifecycle: ``backup_delay_s`` turns a
    TTC estimate into the re-dispatch timer's delay, and ``arm``/``cancel``
    register per-task cancellation hooks (timer cancels) that fire when the
    first result wins — so a completed task can never trigger a late backup,
    and a resolved backup race tears down every outstanding timer exactly
    once."""

    factor: float = 1.5
    max_backups: int = 1
    _armed: Dict[Any, List[Callable[[], None]]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def should_backup(self, elapsed_s: float, ttc_estimate_s: float,
                      backups_sent: int) -> bool:
        return (backups_sent < self.max_backups
                and elapsed_s > self.factor * max(ttc_estimate_s, 1e-6))

    def backup_delay_s(self, ttc_estimate_s: float,
                       backups_sent: int = 0) -> Optional[float]:
        """Delay until the next backup dispatch, or None when exhausted."""
        if backups_sent >= self.max_backups:
            return None
        return self.factor * max(ttc_estimate_s, 1e-6)

    # ------------------------------------------------- cancellation hooks
    def arm(self, key: Any, cancel_fn: Callable[[], None]) -> None:
        """Register a cancellation hook (e.g. a Timer.cancel) for ``key``."""
        self._armed.setdefault(key, []).append(cancel_fn)

    def cancel(self, key: Any) -> int:
        """Fire + drop every hook armed for ``key``; returns how many."""
        hooks = self._armed.pop(key, [])
        for fn in hooks:
            fn()
        return len(hooks)

    def active(self) -> int:
        return sum(len(v) for v in self._armed.values())
