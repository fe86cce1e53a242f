"""Fault injection and failure recovery (DESIGN.md §Fault model)."""
from .chaos import ChaosController
from .plan import (CrashEvent, FaultPlan, GossipFault, LinkFault, Partition,
                   SlowNode)

__all__ = [
    "ChaosController",
    "CrashEvent",
    "FaultPlan",
    "GossipFault",
    "LinkFault",
    "Partition",
    "SlowNode",
]
