"""Observability primitives of the port (own copy of ``repro.obs``)."""
