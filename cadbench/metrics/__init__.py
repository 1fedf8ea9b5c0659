"""Per-layer metrics: one module a metric, named as in ``BENCHMARK.json``,
each with ``read(records) -> float or None``.  ``records`` is the traced
window (``records.Records``); a reader that finds nothing to read
returns None and the metric is left out of the line."""
