"""Edge Node (EN) pieces of the port (from ``repro/core/edge_node.py``).

Only ``TTCEstimator`` is ported so far: the serving engine's per-service
time-to-completion statistics.  ``EdgeNode``, ``Service``, the compute seam
and load telemetry come with the simulator slice.
"""
from __future__ import annotations

from typing import Dict


class TTCEstimator:
    """EWMA service time + queue backlog -> time-to-completion estimate."""

    def __init__(self, alpha: float = 0.2, initial_s: float = 0.085):
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.initial = initial_s

    def observe(self, service: str, exec_time: float) -> None:
        prev = self.ewma.get(service, exec_time)
        self.ewma[service] = (1 - self.alpha) * prev + self.alpha * exec_time

    def informed(self, service: str) -> bool:
        """True once real executions back the estimate (vs the prior)."""
        return service in self.ewma

    def estimate(self, service: str, queue_len: int = 0) -> float:
        base = self.ewma.get(service, self.initial)
        return base * (1 + queue_len)
