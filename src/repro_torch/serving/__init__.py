"""Reuse-aware serving: replica engine and bucket-range router."""
from .engine import ReplicaEngine, ReuseRouter, ServeRequest, ServeResult  # noqa: F401
