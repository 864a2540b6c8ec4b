"""Per-layer metric readers, one file a metric, named as the metric in
``BENCHMARK.json``. Each has ``read(ctx) -> float | None`` over a
``fovbench.harness.Context``; None (nothing to read) leaves the metric out
of the result line."""
