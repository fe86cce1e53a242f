"""Event-loop profiler (own copy of ``repro.obs.profiler``).

Answers "where does a run spend WALL time".  The armed ``EventLoop.run()``
brackets every callback with ``begin``/``end`` here; per callback *site*
(the function's qualname) it accumulates invocation count, cumulative wall
seconds, and the fused-query dispatches made inside
(``repro_torch.kernels.ops.FUSED_DISPATCH_COUNT``, read only if that module
is already loaded), so the ranked report shows both where the host time
goes and which sites pay for device work.  The port has no jit, so its
retrace count is always 0 (the column stays for the reference's report
format).  Registered counter sources add end-of-run totals.

Arming follows the sanitizer pattern: ``RESERVOIR_PROFILE=1`` or
``EventLoop(profile=True)``; disarmed, the loop keeps its zero-cost
dispatch path.  This module lives in ``obs`` deliberately: it is the one
sanctioned consumer of the host wall clock (lint rule D002 bans wall time
inside sim packages because it would leak into the virtual timeline; the
profiler only ever *reports* it).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_ENV = "RESERVOIR_PROFILE"
_OPS = "repro_torch.kernels.ops"


def env_enabled() -> bool:
    """True when RESERVOIR_PROFILE asks for an armed profiler."""
    return os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on")


def _kernel_counters() -> Tuple[int, int]:
    """(fused dispatches, retraces): the dispatch count is read only if the
    kernel module is already loaded; the port has no jit retrace, so the
    second is always 0."""
    ops = sys.modules.get(_OPS)
    return (getattr(ops, "FUSED_DISPATCH_COUNT", 0) if ops else 0, 0)


class _Site:
    __slots__ = ("count", "wall_s", "dispatches", "retraces")

    def __init__(self) -> None:
        self.count = 0
        self.wall_s = 0.0
        self.dispatches = 0
        self.retraces = 0


class Profiler:
    """Per-callback-site accounting for one EventLoop."""

    def __init__(self, loop: Any):
        self.loop = loop
        self.sites: Dict[str, _Site] = {}
        self._sources: Dict[str, Callable[[], int]] = {}

    def add_counter_source(self, name: str, fn: Callable[[], int]) -> None:
        """Register an end-of-run total (e.g. summed store sync pages)."""
        self._sources[name] = fn

    # ------------------------------------------------------------- hot path
    def begin(self) -> Tuple[float, int, int]:
        d, r = _kernel_counters()
        return (time.perf_counter(), d, r)

    def end(self, site: str, mark: Tuple[float, int, int]) -> None:
        wall = time.perf_counter() - mark[0]
        d, r = _kernel_counters()
        s = self.sites.get(site)
        if s is None:
            s = self.sites[site] = _Site()
        s.count += 1
        s.wall_s += wall
        s.dispatches += d - mark[1]
        s.retraces += r - mark[2]

    # -------------------------------------------------------------- reports
    def rows(self) -> List[Dict[str, Any]]:
        """Sites ranked by cumulative wall time (descending)."""
        out = []
        for site, s in self.sites.items():
            out.append({
                "site": site, "count": s.count,
                "wall_s": s.wall_s,
                "mean_us": (s.wall_s / s.count * 1e6) if s.count else 0.0,
                "dispatches": s.dispatches, "retraces": s.retraces,
            })
        out.sort(key=lambda r: r["wall_s"], reverse=True)
        return out

    def totals(self) -> Dict[str, Any]:
        rows = self.rows()
        t = {"events": sum(r["count"] for r in rows),
             "wall_s": sum(r["wall_s"] for r in rows),
             "dispatches": sum(r["dispatches"] for r in rows),
             "retraces": sum(r["retraces"] for r in rows)}
        for name, fn in self._sources.items():
            try:
                t[name] = fn()
            except Exception:  # a crashed source must not kill the report
                t[name] = None
        return t

    def report(self, top: int = 20) -> str:
        """Ranked where-does-the-wall-time-go table."""
        rows = self.rows()
        totals = self.totals()
        total_wall = totals["wall_s"] or 1.0
        lines = [
            f"EventLoop profile: {totals['events']} events, "
            f"{totals['wall_s']:.3f}s wall, "
            f"{totals['dispatches']} kernel dispatches, "
            f"{totals['retraces']} retraces",
            f"{'cum_s':>8} {'%':>5} {'count':>8} {'mean_us':>9} "
            f"{'disp':>6} {'retr':>5}  site",
        ]
        for r in rows[:top]:
            lines.append(
                f"{r['wall_s']:8.3f} {100 * r['wall_s'] / total_wall:5.1f} "
                f"{r['count']:8d} {r['mean_us']:9.1f} "
                f"{r['dispatches']:6d} {r['retraces']:5d}  {r['site']}")
        extra = {k: v for k, v in totals.items()
                 if k not in ("events", "wall_s", "dispatches", "retraces")}
        if extra:
            lines.append("sources: " + ", ".join(
                f"{k}={v}" for k, v in extra.items()))
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"sites": self.rows(), "totals": self.totals()}


def site_of(fn: Callable) -> str:
    """Stable site key for a callback (its qualname)."""
    site: Optional[str] = getattr(fn, "__qualname__", None)
    return site if site is not None else repr(fn)
