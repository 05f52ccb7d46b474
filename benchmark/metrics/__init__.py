"""Per-layer readers, one a metric, found by the metric's name."""
