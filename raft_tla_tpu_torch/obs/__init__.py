"""Observability, the JAX package's ``obs/``: the metrics registry
(``metrics.py``), run events (``events.py``), action coverage
(``coverage.py``), the statespace report (``report.py``), the span tracer
(``tracing.py``), the flight recorder (``flight.py``), Prometheus
exposition (``expose.py``), the run-history ledger (``history.py``), the
chunk profiler and the device-profiler capture (``profile.py``), the
roofline (``roofline.py``), launch accounting (``perf.py``) and the hunt
observatory (``hunt.py``)."""
