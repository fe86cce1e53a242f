"""Reuse-aware serving: replica engine, bucket-range router, the async
engine with its batcher, the sync fleet facade over it, and the compute
backend that puts the engines behind the network simulator's edge nodes."""
from .async_engine import AsyncServingEngine, EngineBackend  # noqa: F401
from .batcher import Batcher  # noqa: F401
from .engine import ReplicaEngine, ReuseRouter, ServeRequest, ServeResult, ServingFleet  # noqa: F401
