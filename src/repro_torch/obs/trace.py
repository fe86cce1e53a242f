"""Per-task tracing on the virtual timeline (own copy of ``repro.obs.trace``).

Spans and point events of a task's life (in the port: the async serving
engine's dispatches, backups and backup wins) are stamped with VIRTUAL time
and exported as Chrome trace-event JSON (the ``traceEvents`` array format),
openable in Perfetto or ``chrome://tracing``.

Arming follows the sanitizer pattern: ``RESERVOIR_TRACE=1`` at EventLoop
construction, or ``EventLoop(trace=True)``.  Disarmed, every hook site is a
single ``tracer is None`` test, and the run is identical to one without a
tracer.

Track model: each task gets its own ``tid`` (= task id) so its spans nest
on one timeline row; shared infrastructure lives on named tracks with
reserved large tids (``TRACK_TID_BASE`` and up).  Cross-track parenting is
by ``args={"task": <tid>}``; no span is left open once the loop drains to
idle.
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, List, Optional, Tuple

_ENV = "RESERVOIR_TRACE"
PID = 1
#: First tid handed to named (non-task) tracks; task ids stay far below.
TRACK_TID_BASE = 1_000_000_000


def env_enabled() -> bool:
    """True when RESERVOIR_TRACE asks for an armed tracer."""
    return os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on")


class Tracer:
    """Chrome-trace-event recorder bound to one EventLoop's virtual clock.

    Spans that cross async hops use explicit handles: ``begin`` returns a
    span id, ``end`` closes it (emitting one complete "X" event).  Point
    events use ``instant``; spans whose duration is known up front use
    ``complete``.  ``open_spans`` exposes what is still unclosed — empty at
    drain-to-idle is the well-formedness invariant.
    """

    def __init__(self, loop: Any):
        self.loop = loop
        self.events: List[Dict[str, Any]] = []
        self._open: Dict[int, Tuple[str, str, int, float, Dict[str, Any]]] = {}
        self._sids = itertools.count(1)
        self._tracks: Dict[str, int] = {}
        self._thread_names: Dict[int, str] = {}

    # ---------------------------------------------------------------- tracks
    def track(self, name: str) -> int:
        """Stable tid for a named (non-task) track, e.g. ``en/fwd1``."""
        tid = self._tracks.get(name)
        if tid is None:
            tid = TRACK_TID_BASE + len(self._tracks)
            self._tracks[name] = tid
            self._thread_names[tid] = name
        return tid

    def name_task(self, tid: int, name: str) -> None:
        if tid not in self._thread_names:
            self._thread_names[tid] = name

    # ----------------------------------------------------------------- spans
    def begin(self, name: str, cat: str, tid: int,
              t: Optional[float] = None, **args: Any) -> int:
        sid = next(self._sids)
        self._open[sid] = (name, cat, tid,
                           self.loop.now if t is None else t, args)
        return sid

    def end(self, sid: Optional[int], t: Optional[float] = None,
            **args: Any) -> None:
        if sid is None:
            return
        entry = self._open.pop(sid, None)
        if entry is None:  # already closed (racing completions): keep first
            return
        name, cat, tid, t0, a0 = entry
        t1 = self.loop.now if t is None else t
        if args:
            a0 = {**a0, **args}
        self.events.append({"name": name, "cat": cat, "ph": "X",
                            "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
                            "pid": PID, "tid": tid, "args": a0})

    def complete(self, name: str, cat: str, tid: int, t0: float,
                 dur: float, **args: Any) -> None:
        self.events.append({"name": name, "cat": cat, "ph": "X",
                            "ts": t0 * 1e6, "dur": max(dur, 0.0) * 1e6,
                            "pid": PID, "tid": tid, "args": args})

    def instant(self, name: str, cat: str, tid: int,
                t: Optional[float] = None, **args: Any) -> None:
        self.events.append({"name": name, "cat": cat, "ph": "i",
                            "ts": (self.loop.now if t is None else t) * 1e6,
                            "s": "t", "pid": PID, "tid": tid, "args": args})

    def open_spans(self) -> List[Tuple[int, str, str, int]]:
        """Unclosed spans as (sid, name, cat, tid) — must be empty once the
        simulation has drained to idle."""
        return [(sid, name, cat, tid)
                for sid, (name, cat, tid, _, _) in self._open.items()]

    def abandon(self, sid: Optional[int], t: Optional[float] = None,
                why: str = "abandoned") -> None:
        """Close a span whose task will never complete (lost past the retx
        budget, stranded at a crashed EN, ...) — the tracing analogue of
        ``Sanitizer.note_loss``."""
        self.end(sid, t, outcome=why)

    # ---------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
            "args": {"name": "reservoir-sim"}}]
        for tid, name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        doc = self.to_chrome()
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
