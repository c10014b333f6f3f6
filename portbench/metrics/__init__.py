"""Per-layer metric readers, one file a metric, named as the metric.  Each
defines ``read(ctx) -> float | None`` over the traced solves
(``harness.layer_context``); None means nothing to read, and the metric is
left out of the line."""
