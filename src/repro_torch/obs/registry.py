"""Unified metrics registry (own copy of ``repro.obs.registry``).

One home for every quantitative signal the stack emits: monotonic
``Counter``s, last-value ``Gauge``s, fixed-bucket ``Histogram``s, and
``CounterGroup``s (the adopted legacy stats dicts).  The registry is ALWAYS
armed — it only ever appends to plain Python containers, consumes zero
randomness, and schedules zero events, so the seeded simulator summaries
hold with it in place.

Hot-path discipline: ``Histogram.observe`` is allocation-free (a bisect over
a fixed edge tuple plus integer bumps), ``Counter.inc``/``CounterGroup.inc``
are single dict/int operations.  Per-interval time-series snapshots ride a
gossip cadence or any manual ``snapshot(t)``.

``CounterGroup`` subclasses ``MutableMapping`` so every existing accessor —
``stats["reused"]``, ``dict(stats)``, ``stats.values()``, equality against a
plain dict — keeps working; ``src/`` code must mutate through ``inc`` (lint
rule O001 flags ``stats[...] += 1`` in sim paths).
"""
from __future__ import annotations

from bisect import bisect_right
from collections.abc import MutableMapping
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# Latency-style edges (seconds): 0.1 ms .. 10 s, roughly logarithmic.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Canonical per-task latency decomposition phases (paper Figs. 8-10).
PHASES: Tuple[str, ...] = ("forward", "search", "execute", "aggregate")


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.value})"


class Gauge:
    """Last-value gauge."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def __repr__(self) -> str:
        return f"Gauge({self.value})"


class Histogram:
    """Fixed-bucket histogram; ``observe`` is allocation-free.

    ``edges`` are the bucket upper bounds; values above the last edge land
    in the overflow bucket.  Tracks running count/sum/min/max so means and
    coarse quantiles come straight off the buckets without keeping samples.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, edges: Sequence[float] = LATENCY_BUCKETS_S):
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the upper edge of the bucket holding
        the q-th sample (``max`` for the overflow bucket)."""
        if not self.count:
            return float("nan")
        want = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= want and c:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "mean": self.mean() if self.count else None,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "edges": list(self.edges), "counts": list(self.counts)}


class CounterGroup(MutableMapping):
    """A named family of integer counters with dict compatibility.

    Drop-in home for the legacy ``stats`` dicts: reads (``group["reused"]``,
    ``dict(group)``, ``group.items()``, ``group == {...}``) behave exactly
    like the dict they replace.  New ``src/`` code mutates via ``inc`` —
    ``group[...] += 1`` still works (tests and external code rely on it) but
    is flagged by lint rule O001 inside sim paths.
    """

    __slots__ = ("_d",)

    def __init__(self, initial: Optional[Dict[str, int]] = None):
        self._d: Dict[str, int] = dict(initial or {})

    def inc(self, key: str, n: int = 1) -> None:
        self._d[key] = self._d.get(key, 0) + n

    # --- MutableMapping interface
    def __getitem__(self, key: str) -> int:
        return self._d[key]

    def __setitem__(self, key: str, value: int) -> None:
        self._d[key] = value

    def __delitem__(self, key: str) -> None:
        del self._d[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"CounterGroup({self._d!r})"


class MetricsRegistry:
    """The single sink: named counters/gauges/histograms plus adopted
    ``CounterGroup``s, with per-interval time-series snapshots."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.groups: Dict[str, CounterGroup] = {}
        self.series: List[Dict[str, Any]] = []

    # --------------------------------------------------------- get-or-create
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  edges: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(edges)
        return h

    def adopt(self, name: str, group: CounterGroup) -> CounterGroup:
        """Re-home an existing CounterGroup (a legacy stats dict) under
        ``name``; the owner keeps mutating its own reference."""
        self.groups[name] = group
        return group

    # ------------------------------------------------- latency decomposition
    def phase(self, name: str) -> Histogram:
        """Histogram for one completion-time phase (``PHASES``)."""
        return self.histogram(f"phase/{name}_s")

    def observe_phase(self, name: str, seconds: float) -> None:
        self.phase(name).observe(seconds)

    def phase_summary(self) -> Dict[str, float]:
        """Per-phase decomposition (mean ms + sample count) — THE source for
        the forward/search/execute/aggregate report (paper Figs. 8-10);
        launch/serve.py and the benchmarks read this instead of re-deriving
        phase latencies from ``TaskRecord`` fields."""
        out: Dict[str, float] = {}
        for p in PHASES:
            h = self.histograms.get(f"phase/{p}_s")
            out[f"{p}_ms"] = (h.mean() * 1e3) if h and h.count else float("nan")
            out[f"{p}_n"] = h.count if h else 0
        return out

    # -------------------------------------------------------------- snapshot
    def snapshot(self, t: float) -> Dict[str, Any]:
        """Append one time-series sample (called on the gossip cadence)."""
        snap: Dict[str, Any] = {"t": t}
        for name, c in self.counters.items():
            snap[name] = c.value
        for name, g in self.gauges.items():
            snap[name] = g.value
        for name, h in self.histograms.items():
            snap[f"{name}/count"] = h.count
            snap[f"{name}/sum"] = h.sum
        for gname, grp in self.groups.items():
            for k, v in grp.items():
                snap[f"{gname}/{k}"] = v
        self.series.append(snap)
        return snap

    def to_dict(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.to_dict() for k, h in self.histograms.items()},
            "groups": {k: dict(g) for k, g in self.groups.items()},
            "series": list(self.series),
        }
