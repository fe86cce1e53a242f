"""Virtual-clock event loop (port of ``repro/core/sim_clock.py``).

A deterministic discrete-event loop ordered by (time, insertion sequence),
the scheduling substrate of the network simulator (``core/network.py``)
and the async serving engine (``serving/async_engine.py``).  Pure
Python: no torch, so times and their arithmetic are exactly the reference's.

Three primitives:

* ``EventLoop``  — the heap itself: ``at``/``call_later`` schedule callbacks,
  ``run`` drains events in virtual-time order, ``now`` is the clock.
* ``Timer``      — handle returned by ``at``: ``cancel()`` makes the event a
  no-op when it pops (O(1); the heap entry stays until its time comes).
* ``Future``     — single-assignment result cell with done-callbacks and
  first-result-wins semantics (``try_set_result`` returns False for losers),
  the resolution primitive behind PIT follower coalescing and backup
  re-dispatch (paper §II PIT aggregation, §IV-C TTC-driven stragglers).

Everything is synchronous under the hood — callbacks run inline when their
event pops — so the loop is deterministic and needs no threads or asyncio.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Optional, Tuple

from ..analysis import sanitizer as _sanitize
from ..obs import profiler as _profiler
from ..obs import trace as _trace


class Timer:
    """Cancellable handle for one scheduled event."""

    __slots__ = ("when", "cancelled")

    def __init__(self, when: float):
        self.when = when
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class RepeatingTimer:
    """Self-rescheduling periodic event with a stop-when-idle contract.

    ``fn()`` runs every ``interval_s``; returning a falsy value stops the
    chain (no further events are scheduled), which is what keeps a
    drain-to-idle ``EventLoop.run()`` terminating: a periodic service (e.g.
    the federation telemetry gossip) must stop rescheduling itself once the
    activity it serves has ceased, and can be ``kick()``-ed back to life by
    the next burst of activity."""

    __slots__ = ("loop", "interval_s", "fn", "_timer")

    def __init__(self, loop: "EventLoop", interval_s: float, fn: Callable[[], Any]):
        self.loop = loop
        self.interval_s = float(interval_s)
        self.fn = fn
        self._timer: Optional[Timer] = None

    @property
    def running(self) -> bool:
        return self._timer is not None and not self._timer.cancelled

    def kick(self) -> None:
        """(Re)start the chain if it is not already ticking."""
        if not self.running:
            self._timer = self.loop.call_later(self.interval_s, self._tick)

    def _tick(self) -> None:
        self._timer = None
        if self.fn():
            self._timer = self.loop.call_later(self.interval_s, self._tick)

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class EventLoop:
    """Deterministic virtual-clock event loop (min-heap by (t, seq))."""

    def __init__(self, start: float = 0.0,
                 sanitize: Optional[bool] = None,
                 trace: Optional[bool] = None,
                 profile: Optional[bool] = None):
        self._now = float(start)
        self._events: List[Tuple[float, int, Timer, Callable, tuple]] = []
        self._seq = itertools.count()
        self.processed = 0
        # sanitize=None defers to RESERVOIR_SANITIZE; the armed loop carries
        # a Sanitizer, the disarmed one a None so every hook site below is a
        # single attribute test on the hot path.  trace / profile follow the
        # same contract with RESERVOIR_TRACE / RESERVOIR_PROFILE.
        if sanitize is None:
            sanitize = _sanitize.env_enabled()
        self._san: Optional[_sanitize.Sanitizer] = (
            _sanitize.Sanitizer(self) if sanitize else None)
        if trace is None:
            trace = _trace.env_enabled()
        self._tracer: Optional[_trace.Tracer] = (
            _trace.Tracer(self) if trace else None)
        if profile is None:
            profile = _profiler.env_enabled()
        self._prof: Optional[_profiler.Profiler] = (
            _profiler.Profiler(self) if profile else None)

    @property
    def sanitizer(self) -> Optional[_sanitize.Sanitizer]:
        """The armed Sanitizer, or None when disarmed."""
        return self._san

    @property
    def tracer(self) -> Optional[_trace.Tracer]:
        """The armed Tracer, or None when disarmed."""
        return self._tracer

    @property
    def profiler(self) -> Optional[_profiler.Profiler]:
        """The armed Profiler, or None when disarmed."""
        return self._prof

    @property
    def now(self) -> float:
        return self._now

    def __len__(self) -> int:
        return len(self._events)

    def at(self, t: float, fn: Callable, *args) -> Timer:
        """Schedule ``fn(*args)`` at virtual time ``t``; returns its Timer."""
        san = self._san
        if san is not None and t < self._now:
            san.fail("timer-in-past",
                     f"timer for {getattr(fn, '__qualname__', fn)!r} "
                     f"scheduled at t={t:.6f} which is before now="
                     f"{self._now:.6f}: it would run 'immediately' but "
                     "stamped with an already-elapsed time",
                     t=t, now=self._now)
        timer = Timer(t)
        heapq.heappush(self._events, (t, next(self._seq), timer, fn, args))
        return timer

    def call_later(self, delay: float, fn: Callable, *args) -> Timer:
        return self.at(self._now + delay, fn, *args)

    def every(self, interval_s: float, fn: Callable[[], Any]) -> RepeatingTimer:
        """Activity-gated periodic event: ``fn`` repeats while truthy.

        The returned ``RepeatingTimer`` is NOT started — call ``kick()``.
        This keeps idle loops drainable: a periodic service only ticks while
        it keeps reporting activity."""
        return RepeatingTimer(self, interval_s, fn)

    def run(self, until: float = float("inf"),
            max_events: int = 5_000_000) -> float:
        """Drain events with t <= ``until`` (in order); returns the clock.

        With a finite horizon the clock advances to ``until`` even when no
        event lands exactly there (standard DES semantics), so arrivals
        injected after a partial drain happen *at* the horizon."""
        n = 0
        san = self._san
        prof = self._prof
        if san is None and prof is None:
            # zero-cost path: no per-event closure, context, or clock reads
            while self._events and n < max_events:
                t, _, timer, fn, args = self._events[0]
                if t > until:
                    break
                heapq.heappop(self._events)
                if timer.cancelled:
                    continue
                self._now = t
                fn(*args)
                n += 1
                self.processed += 1
        else:
            while self._events and n < max_events:
                t, _, timer, fn, args = self._events[0]
                if t > until:
                    break
                heapq.heappop(self._events)
                if timer.cancelled:
                    continue
                self._now = t
                if san is not None:
                    san.push_context(
                        f"{getattr(fn, '__qualname__', fn)!r} @ t={t:.6f}")
                mark = prof.begin() if prof is not None else None
                try:
                    fn(*args)
                finally:
                    if prof is not None:
                        prof.end(_profiler.site_of(fn), mark)
                    if san is not None:
                        san.pop_context()
                n += 1
                self.processed += 1
            if san is not None and not self._events and n < max_events:
                # true drain-to-idle (not a horizon break): audit the
                # subsystem invariants that only hold at quiescence
                san.run_idle_checks()
        if until != float("inf") and n < max_events and self._now < until:
            self._now = until
        return self._now

    def clear(self) -> None:
        self._events.clear()


class Future:
    """Single-assignment result with done-callbacks (virtual-clock flavour).

    ``try_set_result`` implements first-result-wins: the first caller
    resolves the future and fires the callbacks inline; later callers get
    ``False`` and must treat their result as redundant (e.g. a backup
    request finishing after the primary).

    Futures can also *fail*: ``try_set_exception`` rejects every waiter with
    the given exception instead of a value, so a crashed backend or a dead
    remote EN resolves its followers deterministically rather than leaving
    them pending forever.  ``result`` raises the stored exception;
    done-callbacks fire either way and must consult ``exception`` (or use
    ``propagate``/``then``, which route errors for them).
    """

    __slots__ = ("_result", "_exception", "_done", "_callbacks",
                 "resolved_at", "_late_ok")

    def __init__(self):
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._done = False
        self._callbacks: List[Callable[["Future"], None]] = []
        self.resolved_at: Optional[float] = None
        self._late_ok = False

    def allow_late(self) -> None:
        """Mark a *designed* resolve-after-rejection race (e.g. a slow
        remote reply still allowed to lose against an offload-timeout
        abort) so the sanitizer's resolve-after-exception check stays
        quiet for this future."""
        self._late_ok = True

    @property
    def done(self) -> bool:
        return self._done

    @property
    def exception(self) -> Optional[BaseException]:
        return self._exception

    @property
    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("Future not resolved yet")
        if self._exception is not None:
            raise self._exception
        return self._result

    def _finish(self) -> None:
        self._done = True
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def try_set_result(self, value: Any, now: Optional[float] = None) -> bool:
        if self._done:
            if self._exception is not None and not self._late_ok:
                san = _sanitize.current()
                if san is not None:
                    san.fail("future-resolve-after-exception",
                             "try_set_result on a future already rejected "
                             f"with {self._exception!r}: the value is "
                             "silently dropped after waiters saw an error; "
                             "mark designed races with allow_late()",
                             exception=repr(self._exception))
            return False
        self._result = value
        self.resolved_at = now
        self._finish()
        return True

    def set_result(self, value: Any, now: Optional[float] = None) -> None:
        if self._done:
            san = _sanitize.current()
            if san is not None:
                san.fail("future-double-resolve",
                         "set_result on an already-resolved future: two "
                         "code paths both believe they own this result "
                         "(racers must use try_set_result)",
                         prior_exception=repr(self._exception))
        if not self.try_set_result(value, now):
            raise RuntimeError("Future already resolved")

    def try_set_exception(self, exc: BaseException,
                          now: Optional[float] = None) -> bool:
        """Reject the future (first-outcome-wins, same as try_set_result)."""
        if self._done:
            return False
        self._exception = exc
        self.resolved_at = now
        self._finish()
        return True

    def set_exception(self, exc: BaseException,
                      now: Optional[float] = None) -> None:
        if self._done:
            san = _sanitize.current()
            if san is not None:
                san.fail("future-double-resolve",
                         "set_exception on an already-resolved future "
                         "(racers must use try_set_exception)",
                         exception=repr(exc))
        if not self.try_set_exception(exc, now):
            raise RuntimeError("Future already resolved")

    def add_done_callback(self, fn: Callable[["Future"], None]) -> None:
        if self._done:
            fn(self)
        else:
            self._callbacks.append(fn)

    def propagate(self, out: "Future") -> bool:
        """Forward this (resolved) future's outcome — value or exception —
        to ``out``.  The safe way to chain futures from a done-callback:
        ``f.add_done_callback(lambda f: f.propagate(out))`` never raises,
        unlike touching ``f.result`` directly."""
        if self._exception is not None:
            return out.try_set_exception(self._exception, now=self.resolved_at)
        return out.try_set_result(self._result, now=self.resolved_at)

    def then(self, fn: Callable[[Any], Any]) -> "Future":
        """Derived future resolving with ``fn(result)`` when this one does.

        The adaptation seam between result vocabularies (e.g. a serving
        engine's ``ServeResult`` -> the network's ``ExecCompletion``): the
        derived future inherits ``resolved_at``, so virtual-time attribution
        survives the mapping.  Resolves inline if this future is done.
        Errors propagate: if this future fails, or ``fn`` raises, the
        derived future fails with that exception instead of resolving."""
        out = Future()

        def _chain(f: "Future") -> None:
            if f._exception is not None:
                out.try_set_exception(f._exception, now=f.resolved_at)
                return
            try:
                value = fn(f._result)
            except Exception as exc:  # adapter failure rejects followers
                out.try_set_exception(exc, now=f.resolved_at)
                return
            out.try_set_result(value, now=f.resolved_at)

        self.add_done_callback(_chain)
        return out
