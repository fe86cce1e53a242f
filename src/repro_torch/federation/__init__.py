"""Federation layer: reuse-aware cross-EN offloading and load balancing.

Builds on the rFIB + ``ComputeBackend``/``EngineBackend`` seams (DESIGN.md
§Federation): per-EN load telemetry gossiped on the shared ``sim_clock``
EventLoop (``telemetry``), pluggable reuse-aware offload policies
(``policy``), and the federated NDN execution exchange plus load-driven
rFIB rebalance (``federator``).
"""
from .federator import Federator  # noqa: F401
from .policy import (  # noqa: F401
    POLICY_NAMES,
    LeastLoadedPolicy,
    LocalOnlyPolicy,
    OffloadContext,
    OffloadPolicy,
    ReuseAffinityPolicy,
    get_policy,
)
from .telemetry import TelemetryGossip  # noqa: F401
