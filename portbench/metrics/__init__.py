"""One reader per metric, in ``metrics/<metric name>.py``, found by the
name ``BENCHMARK.json`` gives it; where there is no file of the whole
name, the longest name that the metric's begins with, cut at a dot
(``device_idle.serve_poisson`` is read by ``device_idle.py``,
``serve_images_per_s.transformer`` by ``serve_images_per_s.py``).
``read(ctx)`` returns the value, or None where the run holds nothing to
read it from (the harness then leaves the metric out of the line)."""
