"""Observability, the JAX package's ``obs/`` (host code only): the metrics
registry (``metrics.py``), run events (``events.py``), action coverage
(``coverage.py``) and the statespace report (``report.py``)."""
