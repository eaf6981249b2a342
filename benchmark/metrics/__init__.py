"""One reader a metric, `read(run) -> value or None`, found by the metric's name."""
