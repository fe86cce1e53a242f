"""Span recorder on one of two clocks (own copy of ``repro.obs.trace``).

One ``Tracer`` records on the clock it is given:

* **Virtual** (the default, ``Tracer(loop)``): the event loop's ``now`` in
  seconds.  Spans and point events of a task's life (in the port: the async
  serving engine's dispatches, backups and backup wins) are stamped with
  virtual time.  Arming follows the sanitizer pattern: ``RESERVOIR_TRACE=1``
  at EventLoop construction, or ``EventLoop(trace=True)``.  Disarmed, every
  hook site is a single ``tracer is None`` test, and the run is identical to
  one without a tracer.
* **Wall** (``Tracer.wall()``): ``time.perf_counter_ns()``, integer
  nanoseconds, the clock ``torch.profiler``'s device events are placed on by
  a marker kernel, so program spans and device operations share one
  timeline.  The serving path (``ServingFleet.submit_batch_sync``, the
  replicas, the reuse store, ``launch/serve.py::make_executor``) opens
  nested spans on the module's wall recorder through ``span(name)``, once a
  batch, never a task.  Arming is a call: ``arm_wall()`` / ``disarm_wall()``;
  besides, ``follow_profiler()`` (called once a fleet submission) arms the
  recorder while ``torch.profiler`` records and disarms what it armed once
  the profiler has stopped, so a profiled window carries its program spans.
  Armed, the recorder also records each garbage-collector pass as a ``gc``
  span.  Disarmed, ``span`` is one ``is None`` test returning the shared,
  falsy ``NOOP``; a site computes a span's arguments only under ``if sp:``.
  A span reads the host clock and nothing else: no device synchronisation,
  no host read of a tensor.

``span`` records (id, parent id, name, start, end, args) into
``Tracer.spans``; the parent is the innermost span open when it began (0
for none).  Spans nest by ``with`` blocks on the thread that serves.  Both
clocks export as Chrome trace-event JSON (the ``traceEvents`` array
format), openable in Perfetto or ``chrome://tracing``.

Track model: each task gets its own ``tid`` (= task id) so its spans nest
on one timeline row; shared infrastructure lives on named tracks with
reserved large tids (``TRACK_TID_BASE`` and up); ``span`` spans go on the
``spans`` track.  Cross-track parenting is by ``args={"task": <tid>}``; no
span is left open once the loop drains to idle.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_ENV = "RESERVOIR_TRACE"
PID = 1
#: First tid handed to named (non-task) tracks; task ids stay far below.
TRACK_TID_BASE = 1_000_000_000

#: One recorded ``span``: (id, parent id, name, start, end, args or None).
Span = Tuple[int, int, str, Any, Any, Optional[Dict[str, Any]]]


def env_enabled() -> bool:
    """True when RESERVOIR_TRACE asks for an armed tracer."""
    return os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on")


class _NoSpan:
    """What ``span`` returns when disarmed: a context manager that does
    nothing, falsy so that a site skips computing its arguments."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def note(self, **args: Any) -> None:
        return None


NOOP = _NoSpan()


class _Span:
    """One open ``Tracer.span``; recorded when its ``with`` block ends."""

    __slots__ = ("_tr", "name", "args", "sid", "parent", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict[str, Any]]):
        self._tr, self.name, self.args = tracer, name, args

    def __enter__(self) -> "_Span":
        tr = self._tr
        stack = tr._stack
        self.sid = next(tr._sids)
        self.parent = stack[-1].sid if stack else 0
        stack.append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        tr = self._tr
        t1 = tr.clock()
        tr._stack.pop()
        tr.spans.append((self.sid, self.parent, self.name, self.t0, t1, self.args))

    def note(self, **args: Any) -> None:
        """Add arguments to the span (kept with it when it ends)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)


class Tracer:
    """Chrome-trace-event recorder on an injected clock.

    ``Tracer(loop)`` reads the loop's virtual ``now`` (seconds);
    ``Tracer.wall()`` reads ``time.perf_counter_ns`` (nanoseconds).
    ``us_per_tick`` converts the clock's unit to the export's microseconds.

    Spans that cross async hops use explicit handles: ``begin`` returns a
    span id, ``end`` closes it (emitting one complete "X" event).  Point
    events use ``instant``; spans whose duration is known up front use
    ``complete``; nested spans of one thread use ``span``.  ``open_spans``
    exposes what is still unclosed — empty at drain-to-idle is the
    well-formedness invariant.
    """

    def __init__(self, loop: Any = None, clock: Optional[Callable[[], Any]] = None,
                 us_per_tick: float = 1e6):
        self.loop = loop
        self.clock: Callable[[], Any] = clock if clock is not None else (lambda: loop.now)
        self.us_per_tick = us_per_tick
        self.events: List[Dict[str, Any]] = []
        self.spans: List[Span] = []
        self._open: Dict[int, Tuple[str, str, int, float, Dict[str, Any]]] = {}
        self._stack: List[_Span] = []
        self._sids = itertools.count(1)
        self._tracks: Dict[str, int] = {}
        self._thread_names: Dict[int, str] = {}
        self._gc_open: Optional[Tuple[int, Any]] = None

    @classmethod
    def wall(cls) -> "Tracer":
        """A recorder on the host's ``perf_counter_ns`` clock."""
        return cls(clock=time.perf_counter_ns, us_per_tick=1e-3)

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
                           self.clock() if t is None else t, args)
        return sid

    def end(self, sid: Optional[int], t: Optional[float] = None,
            **args: Any) -> None:
        if sid is None:
            return
        entry = self._open.pop(sid, None)
        if entry is None:  # already closed (racing completions): keep first
            return
        name, cat, tid, t0, a0 = entry
        t1 = self.clock() if t is None else t
        if args:
            a0 = {**a0, **args}
        us = self.us_per_tick
        self.events.append({"name": name, "cat": cat, "ph": "X",
                            "ts": t0 * us, "dur": max(t1 - t0, 0.0) * us,
                            "pid": PID, "tid": tid, "args": a0})

    def complete(self, name: str, cat: str, tid: int, t0: float,
                 dur: float, **args: Any) -> None:
        us = self.us_per_tick
        self.events.append({"name": name, "cat": cat, "ph": "X",
                            "ts": t0 * us, "dur": max(dur, 0.0) * us,
                            "pid": PID, "tid": tid, "args": args})

    def instant(self, name: str, cat: str, tid: int,
                t: Optional[float] = None, **args: Any) -> None:
        self.events.append({"name": name, "cat": cat, "ph": "i",
                            "ts": (self.clock() if t is None else t) * self.us_per_tick,
                            "s": "t", "pid": PID, "tid": tid, "args": args})

    def span(self, name: str, **args: Any) -> _Span:
        """``with tracer.span(name, **args) as sp:`` records the block as a
        span nested in the innermost one open; ``sp.note(**args)`` adds
        arguments known only inside it."""
        return _Span(self, name, args or None)

    def open_spans(self) -> List[Tuple[int, str, str, int]]:
        """Unclosed spans as (sid, name, cat, tid) — must be empty once the
        simulation has drained to idle (nested ``span`` spans: cat "span",
        tid 0)."""
        return ([(sid, name, cat, tid)
                 for sid, (name, cat, tid, _, _) in self._open.items()]
                + [(s.sid, s.name, "span", 0) for s in self._stack])

    def abandon(self, sid: Optional[int], t: Optional[float] = None,
                why: str = "abandoned") -> None:
        """Close a span whose task will never complete (lost past the retx
        budget, stranded at a crashed EN, ...) — the tracing analogue of
        ``Sanitizer.note_loss``."""
        self.end(sid, t, outcome=why)

    # --------------------------------------------------- garbage collector
    def _on_gc(self, phase: str, info: Dict[str, Any]) -> None:
        """``gc.callbacks`` hook: each collection as a ``gc`` span, nested
        in the span open when it began."""
        if phase == "start":
            self._gc_open = (self._stack[-1].sid if self._stack else 0, self.clock())
        elif self._gc_open is not None:
            parent, t0 = self._gc_open
            self._gc_open = None
            self.spans.append((next(self._sids), parent, "gc", t0, self.clock(),
                               {"generation": info.get("generation"),
                                "collected": info.get("collected")}))

    # ---------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
            "args": {"name": "reservoir-sim"}}]
        events = self.events
        if self.spans:
            us, tid = self.us_per_tick, self.track("spans")
            events = events + [
                {"name": name, "cat": "span", "ph": "X", "ts": t0 * us,
                 "dur": max(t1 - t0, 0) * us, "pid": PID, "tid": tid,
                 "args": {**(args or {}), "id": sid, "parent": parent}}
                for sid, parent, name, t0, t1, args in self.spans]
        for tid, name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": PID,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        doc = self.to_chrome()
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ----------------------------------------------------- the wall recorder
_wall: Optional[Tracer] = None        # armed now
_last: Optional[Tracer] = None        # armed now or last disarmed
_by_profiler = False                  # armed by follow_profiler


def arm_wall() -> Tracer:
    """Arm the module's wall recorder (a fresh one unless armed already)
    and its ``gc`` spans; -> the recorder."""
    global _wall, _last
    if _wall is None:
        _wall = _last = Tracer.wall()
        gc.callbacks.append(_wall._on_gc)
    return _wall


def disarm_wall() -> Optional[Tracer]:
    """Disarm the wall recorder; -> it (its spans stay readable, also
    through ``wall()``), or None if none was armed."""
    global _wall, _by_profiler
    tr, _wall, _by_profiler = _wall, None, False
    if tr is not None and tr._on_gc in gc.callbacks:
        gc.callbacks.remove(tr._on_gc)
    return tr


def wall() -> Optional[Tracer]:
    """The wall recorder armed now, else the last one disarmed, else None."""
    return _last


def span(name: str) -> Any:
    """A nested span of the armed wall recorder, or ``NOOP`` when disarmed
    (``with span(name) as sp: ...; if sp: sp.note(**args)``)."""
    tr = _wall
    return NOOP if tr is None else _Span(tr, name, None)


def follow_profiler() -> None:
    """Arm the wall recorder while ``torch.profiler`` records; disarm what
    this armed once it has stopped (an ``arm_wall()`` stays armed)."""
    global _by_profiler
    torch = sys.modules.get("torch")
    on = torch is not None and torch.autograd._profiler_enabled()
    if on and _wall is None:
        arm_wall()
        _by_profiler = True
    elif not on and _by_profiler:
        disarm_wall()
