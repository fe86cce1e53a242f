"""Runtime sanitizer hooks and the static linter of the port (own copies of
``repro.analysis``: ``sanitizer.py``, ``lint.py``)."""
