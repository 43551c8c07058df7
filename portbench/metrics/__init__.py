"""Per-layer metrics, one reader per file (``<metric>.py``), found by the
metric's name in ``BENCHMARK.json``.  A reader's ``read(trace, window, run,
cell)`` returns the metric from the traced run, or None where it finds
nothing to read."""
