"""Per-layer metric readers: ``<metric name>.py`` holds ``read(view)``,
which takes the metric from a traced run's ``harness.RunView`` and returns
its value, or None when it finds nothing to read (the metric is then left
out of the line)."""
