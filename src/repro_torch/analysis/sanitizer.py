"""Runtime invariant sanitizer (own copy of ``repro.analysis.sanitizer``).

Armed with ``RESERVOIR_SANITIZE=1`` (or ``EventLoop(sanitize=True)``), the
event loop and the reuse store run cheap invariant checks at seams static
analysis cannot see:

* **Future double-resolution** and **resolve-after-exception**: a second
  ``set_result``/``set_exception`` on a done Future means two code paths
  both think they own the result (racers must use ``try_set_result``).
* **Timers scheduled in the past**: ``loop.at(t)`` with ``t < now`` would
  run "immediately" but stamped with a time that already elapsed,
  corrupting any latency derived from it.
* **Idle-time audits** registered by subsystems (``add_idle_check``), run
  when the loop drains to idle; losses excused via ``note_loss``.
* **Dirty-page conservation across sync_device()** and host/device mirror
  coherence of the reuse store's pages and slot tables.
* **Slot-table trailing-(-1) validity**: every bucket row is a prefix of
  valid slots followed by -1 padding.
* **Id conservation across migration**: every batch sent must arrive
  exactly once or be excused as a loss.

Failures raise :class:`SanitizerError` carrying provenance: which callback
was running and at what virtual time.  An armed ``EventLoop`` pushes its
``Sanitizer`` on the module stack around each callback, so objects without
a loop reference (Futures, stores) find it through :func:`current`.
Disarmed, every hook site is a single ``None`` check on the hot path.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SanitizerError", "Sanitizer", "env_enabled", "current"]


def env_enabled() -> bool:
    """True iff ``RESERVOIR_SANITIZE`` is set to a truthy value."""
    return os.environ.get("RESERVOIR_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


class SanitizerError(RuntimeError):
    """Structured invariant-violation report.

    Subclasses ``RuntimeError`` so pre-existing callers that guard against
    e.g. Future double-resolve with ``except RuntimeError`` keep working
    when the sanitizer upgrades the message with provenance.

    Attributes:
        check: short invariant id, e.g. ``"future-double-resolve"``.
        provenance: human-readable origin of the offending event — which
            callback scheduled it and at what virtual time (empty when no
            event context is active).
        details: free-form structured payload for tests/tooling.
    """

    def __init__(self, check: str, message: str,
                 provenance: str = "", **details: Any):
        self.check = check
        self.provenance = provenance
        self.details = details
        full = f"[sanitize:{check}] {message}"
        if provenance:
            full += f" (provenance: {provenance})"
        super().__init__(full)


class Sanitizer:
    """Per-EventLoop invariant checker; one instance per armed loop.

    The loop pushes an event-context string (callback name + scheduled-at
    virtual time) around each callback dispatch so violations raised from
    arbitrary depths can report which event was running.  A module-level
    stack (:func:`current`) lets objects with no loop reference — Futures —
    find the active sanitizer.
    """

    def __init__(self, loop: Any = None):
        self.loop = loop
        self._ctx: List[str] = []
        # names excused from the idle-time leak checks (injected losses,
        # retransmission give-ups, drops at crashed nodes)
        self._excused_losses: Dict[str, str] = {}
        # migration conservation ledger, keyed by the globally-unique batch
        # name /<dst-prefix>/<svc>/migrate/<seq>:
        #   name -> (n_entries, fingerprint) at send time
        self._migrations_out: Dict[str, Tuple[int, int]] = {}
        self._migrations_in: Dict[str, int] = {}
        # idle-check callbacks registered by subsystems
        self._idle_checks: List[Any] = []

    # ------------------------------------------------------------ context
    def push_context(self, desc: str) -> None:
        self._ctx.append(desc)
        _STACK.append(self)

    def pop_context(self) -> None:
        self._ctx.pop()
        _STACK.pop()

    def provenance(self) -> str:
        return self._ctx[-1] if self._ctx else ""

    def fail(self, check: str, message: str, **details: Any) -> None:
        raise SanitizerError(check, message, self.provenance(), **details)

    # --------------------------------------------------------- loss ledger
    def note_loss(self, name: str, why: str) -> None:
        """Excuse ``name`` from the idle-time leak checks (injected drop,
        retransmission give-up, crashed node)."""
        self._excused_losses[name] = why

    def is_excused(self, name: str) -> bool:
        return name in self._excused_losses

    # ---------------------------------------------------------- idle hooks
    def add_idle_check(self, fn: Any) -> None:
        """Register ``fn()`` to run when the loop drains to true idle."""
        self._idle_checks.append(fn)

    def run_idle_checks(self) -> None:
        for fn in self._idle_checks:
            fn()
        self.check_migrations_settled()

    # ------------------------------------------------------ migration hooks
    def note_migration_out(self, name: str, n: int,
                           fingerprint: int) -> None:
        if name in self._migrations_out:
            self.fail("migration-duplicate-send",
                      f"migration batch {name!r} sent twice", name=name)
        self._migrations_out[name] = (n, fingerprint)

    def note_migration_in(self, name: str, n: int,
                          fingerprint: int) -> None:
        sent = self._migrations_out.get(name)
        if sent is None:
            self.fail("migration-unknown-batch",
                      f"migration batch {name!r} arrived but was never "
                      f"sent ({n} entries)", name=name, n=n)
        if self._migrations_in.get(name):
            self.fail("migration-duplicate-delivery",
                      f"migration batch {name!r} delivered twice: entries "
                      "would be duplicated at the destination", name=name)
        self._migrations_in[name] = 1
        if sent is not None and (n, fingerprint) != sent:
            self.fail("migration-id-conservation",
                      f"migration batch {name!r} mutated in flight: sent "
                      f"{sent[0]} entries (fp={sent[1]:#x}), received "
                      f"{n} (fp={fingerprint:#x})",
                      name=name, sent=sent, received=(n, fingerprint))

    def note_migration_lost(self, name: str, why: str) -> None:
        """Excuse an in-flight batch (chaos loss / crashed endpoint)."""
        self._migrations_in[name] = 1  # accounted-for: designed cache loss

    def check_migrations_settled(self) -> None:
        """Idle-time audit: every sent batch must be delivered or excused."""
        for name, (n, fp) in sorted(self._migrations_out.items()):
            if name not in self._migrations_in:
                self.fail("migration-id-loss",
                          f"migration batch {name!r} ({n} entries, "
                          f"fp={fp:#x}) was sent but never delivered nor "
                          "excused: entries silently lost", name=name, n=n)


# Module-level active-sanitizer stack: Futures carry no loop reference, so
# they look here for the sanitizer of whatever loop is currently
# dispatching.  Empty outside callback dispatch (and always when disarmed).
_STACK: List[Sanitizer] = []


def current() -> Optional[Sanitizer]:
    """The sanitizer of the innermost armed loop currently dispatching."""
    return _STACK[-1] if _STACK else None
