"""Runtime invariant sanitizer hooks (own copy of ``repro.analysis.sanitizer``).

Armed with ``RESERVOIR_SANITIZE=1``, the reuse store audits its host/device
mirrors after every sync and its slot tables after every mutation, and raises
:class:`SanitizerError` on a violation.  The port keeps what the store needs:
``env_enabled``, ``SanitizerError`` and ``current``.  The event-loop
sanitizer that pushes provenance contexts comes with the simulator slice;
until then ``current()`` is always ``None`` and errors carry no provenance.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional

__all__ = ["SanitizerError", "env_enabled", "current"]


def env_enabled() -> bool:
    """True iff ``RESERVOIR_SANITIZE`` is set to a truthy value."""
    return os.environ.get("RESERVOIR_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


class SanitizerError(RuntimeError):
    """Structured invariant-violation report.

    Attributes:
        check: short invariant id, e.g. ``"mirror-divergence"``.
        provenance: origin of the offending event (empty outside an armed
            event loop).
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


# Active-sanitizer stack, pushed by an armed event loop around each callback.
_STACK: List[Any] = []


def current() -> Optional[Any]:
    """The sanitizer of the innermost armed loop currently dispatching."""
    return _STACK[-1] if _STACK else None
