"""Observability primitives of the port (own copy of ``repro.obs``).

* ``trace``    — per-task tracing on the virtual timeline, exported as
                 Chrome trace-event / Perfetto JSON; armed via
                 ``RESERVOIR_TRACE=1`` or ``EventLoop(trace=True)``.
* ``registry`` — ``CounterGroup``, the dict-compatible home of the serving
                 engine's counters.
* ``profiler`` — wall-time and fused-dispatch accounting per EventLoop
                 callback site; armed via ``RESERVOIR_PROFILE=1`` or
                 ``EventLoop(profile=True)``.

This package is outside the sim-path lint packages: it is the one place
allowed to read the host's wall clock (the profiler measures the run
itself, never the virtual timeline).
"""
from .profiler import Profiler
from .registry import CounterGroup
from .trace import Tracer

__all__ = ["CounterGroup", "Tracer", "Profiler"]
