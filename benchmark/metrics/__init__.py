"""Per-layer metrics, one reader a file: ``read(trace)`` takes a
``spans.Trace`` and returns the number, or None where the run holds
nothing to read."""
