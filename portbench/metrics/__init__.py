"""One reader per metric, ``<name>.py`` with ``read(ctx) -> float | None``
(``ctx`` is ``core.bench.Context``); None leaves the metric out of the
result's line."""
