"""One file a metric, ``<name>.py``, loaded by path from the metric's
name in BENCHMARK.json. Each defines ``read(run)``: the value, or None
where the run has nothing to read (the harness then leaves the metric
out of the line). ``common`` holds what several share."""
