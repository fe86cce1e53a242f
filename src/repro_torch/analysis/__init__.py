"""Runtime sanitizer hooks of the port (own copy of ``repro.analysis``)."""
