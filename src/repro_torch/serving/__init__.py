"""Reuse-aware serving: replica engine, bucket-range router, the async
engine with its batcher, and the sync fleet facade over it."""
from .async_engine import AsyncServingEngine  # noqa: F401
from .batcher import Batcher  # noqa: F401
from .engine import ReplicaEngine, ReuseRouter, ServeRequest, ServeResult, ServingFleet  # noqa: F401
