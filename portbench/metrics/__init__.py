"""Per-layer metrics: one reader a metric, ``<metric name>.py`` with
``read(ctx)`` (a number, or None where this run gives nothing to read),
and what the readers share: the work counts and rooflines (``work``)
and the run's readings (``context``)."""
