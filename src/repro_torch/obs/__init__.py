"""Observability primitives of the port (own copy of ``repro.obs``).

* ``trace``    — per-task tracing on the virtual timeline, exported as
                 Chrome trace-event / Perfetto JSON; armed via
                 ``RESERVOIR_TRACE=1`` or ``EventLoop(trace=True)``.
* ``registry`` — counters, gauges and histograms (``MetricsRegistry``, the
                 network's per-phase latency decomposition), and
                 ``CounterGroup``, the dict-compatible home of the stats
                 dicts it adopts.
* ``profiler`` — wall-time and fused-dispatch accounting per EventLoop
                 callback site; armed via ``RESERVOIR_PROFILE=1`` or
                 ``EventLoop(profile=True)``.

This package is outside the sim-path lint packages: it is the one place
allowed to read the host's wall clock (the profiler measures the run
itself, never the virtual timeline).
"""
from .profiler import Profiler
from .registry import Counter, CounterGroup, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "Profiler",
]
