"""Metrics exposition: Prometheus text format and a standalone listener.

The JAX package's ``obs/expose.py``, kept as the port's own copy:

- ``render_prometheus``: a registry snapshot as Prometheus text
  exposition (0.0.4).  ``engine/distinct`` becomes
  ``raft_engine_distinct_total`` (counters take ``_total``), gauges keep
  their cleaned name, histograms give cumulative ``_bucket{le=...}``
  rows and ``_sum`` / ``_count``; optional labels (``host="1"`` for one
  controller of a process group) go on every sample.
- ``parse_prometheus``: a strict parser of the same format, what tests
  and tooling use to hold the exposition valid.
- ``serve_metrics`` / ``start_metrics_server``: a threaded HTTP listener
  (``check --metrics-port``, the METRICS_PORT directive) with
  ``/metrics`` (the exposition), ``/flight`` (the flight recorder's ring
  as JSON) and ``/jobs`` (``{"ok": false}`` until a job registry is
  wired, as the JAX listener answers without one).
"""

from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

#: Exposition content type (the 0.0.4 text format).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Every metric name is prefixed so a shared Prometheus can tell this
#: process's series from everything else it scrapes.
NAME_PREFIX = "raft_"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def metric_name(raw: str) -> str:
    """Registry name -> Prometheus metric name: prefix + every
    non-``[a-zA-Z0-9_]`` run collapsed to one ``_``.  ``engine/distinct``
    -> ``raft_engine_distinct``; idempotent for already-clean names."""
    clean = re.sub(r"[^a-zA-Z0-9_]+", "_", raw).strip("_")
    name = NAME_PREFIX + clean
    if not _NAME_OK.match(name):
        name = NAME_PREFIX + "invalid"
    return name


def _esc_label(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    # Integral floats render without the trailing .0 — cosmetic, but it
    # keeps counter lines looking like counters.
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def default_labels() -> Dict[str, str]:
    """Labels of one controller under a process group
    (``parallel/multihost.py``): ``{host: "<i>"}`` with more than one
    process, else none."""
    try:
        from ..parallel import multihost
        if multihost.process_count() > 1:
            return {"host": str(multihost.process_index())}
    except Exception:
        pass
    return {}


def render_prometheus(snapshot: dict,
                      labels: Optional[Dict[str, str]] = None) -> str:
    """Registry ``snapshot()`` dict -> Prometheus text exposition.

    Histogram buckets are re-cumulated from the summary's sparse
    occupied-bucket dict (upper-bound string -> count) into the
    monotone ``le``-labelled series Prometheus requires, closing with
    the mandatory ``le="+Inf"`` row equal to ``_count``."""
    out = []
    for raw, val in sorted((snapshot.get("counters") or {}).items()):
        name = metric_name(raw)
        if not name.endswith("_total"):
            name += "_total"
        out.append(f"# HELP {name} registry counter {raw!r}")
        out.append(f"# TYPE {name} counter")
        out.append(f"{name}{_fmt_labels(labels)} {_fmt_value(val)}")
    for raw, val in sorted((snapshot.get("gauges") or {}).items()):
        name = metric_name(raw)
        out.append(f"# HELP {name} registry gauge {raw!r}")
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{_fmt_labels(labels)} {_fmt_value(val)}")
    for raw, summ in sorted((snapshot.get("histograms") or {}).items()):
        name = metric_name(raw)
        count = int(summ.get("count", 0))
        total = float(summ.get("total", 0.0))
        out.append(f"# HELP {name} registry histogram {raw!r}")
        out.append(f"# TYPE {name} histogram")
        occupied = summ.get("buckets") or {}
        # Sparse occupied buckets -> cumulative le series.  Keys are the
        # upper-bound strings the registry's summary() emits ("+inf"
        # for the overflow bucket).
        finite = sorted(
            ((float(k), c) for k, c in occupied.items()
             if k.lower() not in ("+inf", "inf")),
            key=lambda kv: kv[0])
        cum = 0
        for bound, c in finite:
            cum += int(c)
            lbl = dict(labels or {})
            lbl["le"] = _fmt_value(float(bound))
            out.append(f"{name}_bucket{_fmt_labels(lbl)} {cum}")
        lbl = dict(labels or {})
        lbl["le"] = "+Inf"
        out.append(f"{name}_bucket{_fmt_labels(lbl)} {count}")
        out.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
        out.append(f"{name}_count{_fmt_labels(labels)} {count}")
    return "\n".join(out) + "\n" if out else "\n"


def parse_prometheus(text: str) -> Dict[str, list]:
    """Parse/validate text exposition; returns ``{metric name: [(labels
    dict, value float), ...]}``.  Raises ``ValueError`` on anything a
    strict scraper would reject: malformed sample lines, samples whose
    ``# TYPE`` family was declared twice, non-monotone histogram
    ``_bucket`` series, or a ``_count`` disagreeing with the ``+Inf``
    bucket.  This is the CI gate for the ``metrics`` op / ``/metrics``
    endpoint (the acceptance-criteria "parses as valid exposition")."""
    samples: Dict[str, list] = {}
    types: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                fam, kind = parts[2], (parts[3] if len(parts) > 3 else "")
                if fam in types:
                    raise ValueError(
                        f"line {ln}: duplicate # TYPE for {fam}")
                if kind.split()[0] not in ("counter", "gauge",
                                           "histogram", "summary",
                                           "untyped"):
                    raise ValueError(
                        f"line {ln}: unknown TYPE {kind!r} for {fam}")
                types[fam] = kind.split()[0]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        labels = {}
        if m.group("labels"):
            consumed = 0
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = lm.group(2)
                consumed += 1
            if consumed == 0 and m.group("labels").strip():
                raise ValueError(
                    f"line {ln}: malformed labels: {line!r}")
        raw = m.group("value")
        try:
            value = float(raw.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"line {ln}: bad value {raw!r}: {line!r}")
        samples.setdefault(m.group("name"), []).append((labels, value))
    # Histogram coherence: per family, bucket series monotone in le and
    # the +Inf bucket equals _count.
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        buckets = samples.get(f"{fam}_bucket", [])
        if not buckets:
            raise ValueError(f"histogram {fam} has no _bucket samples")
        def le_key(lv):
            le = lv[0].get("le", "")
            return math.inf if le == "+Inf" else float(le)
        ordered = sorted(buckets, key=le_key)
        counts = [v for _l, v in ordered]
        if any(b > a for a, b in zip(counts[1:], counts)):
            raise ValueError(
                f"histogram {fam}: non-monotone bucket counts {counts}")
        inf_rows = [v for l, v in buckets if l.get("le") == "+Inf"]
        count_rows = [v for _l, v in samples.get(f"{fam}_count", [])]
        if not inf_rows:
            raise ValueError(f"histogram {fam}: missing le=\"+Inf\"")
        if count_rows and inf_rows[0] != count_rows[0]:
            raise ValueError(
                f"histogram {fam}: +Inf bucket {inf_rows[0]} != _count "
                f"{count_rows[0]}")
    return samples


def counter_sample(samples: Dict[str, list], raw_name: str
                   ) -> Optional[float]:
    """Value of the counter exported for registry name ``raw_name``
    (first sample), or None — the stats-vs-metrics agreement check in
    tests/CI reads through this so the name mapping lives in ONE
    place."""
    name = metric_name(raw_name)
    if not name.endswith("_total"):
        name += "_total"
    rows = samples.get(name)
    return rows[0][1] if rows else None


# -- standalone HTTP listener ---------------------------------------------

class _MetricsHandler(BaseHTTPRequestHandler):
    """GET-only: ``/metrics`` (exposition), ``/flight`` (ring JSON),
    ``/`` (tiny index).  Anything else 404s.  Errors answer 500 rather
    than killing the handler thread."""

    server_version = "raft-metrics/1"

    def do_GET(self):                               # noqa: N802 (stdlib API)
        try:
            if self.path.split("?")[0] == "/metrics":
                body = render_prometheus(
                    self.server.registry.snapshot(),
                    labels=self.server.labels).encode()
                ctype = CONTENT_TYPE
            elif self.path.split("?")[0] == "/flight":
                flight = self.server.flight
                if flight is not None:
                    # Attach bookkeeping at most once per minute per
                    # peer, not per poll: a 2 s-interval watcher would
                    # otherwise flood the run's event log and evict
                    # real events from the bounded black-box ring it is
                    # trying to observe — while a later, separate
                    # attach episode from the same host still records.
                    import time as _time
                    peer = str(self.client_address[0])
                    now = _time.monotonic()
                    seen = self.server.seen_watchers
                    if now - seen.get(peer, float("-inf")) > 60.0:
                        seen[peer] = now
                        flight.note_attach(transport="http", peer=peer)
                    # ?last=N trims each kind to its newest N records —
                    # the watch console polls with last=8; the bare
                    # endpoint serves the full ring (the black-box dump
                    # view).
                    last = None
                    q = self.path.partition("?")[2]
                    for kv in q.split("&"):
                        if kv.startswith("last="):
                            try:
                                last = max(1, int(kv[5:]))
                            except ValueError:
                                pass
                    doc = {"ok": True, "seq": flight.seq(),
                           "armed": flight.armed,
                           "records": flight.snapshot(last=last)}
                else:
                    doc = {"ok": False, "error": "no flight recorder"}
                body = (json.dumps(doc, default=str) + "\n").encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/jobs":
                provider = self.server.jobs_provider
                if provider is not None:
                    doc = {"ok": True}
                    doc.update(provider())
                else:
                    doc = {"ok": False, "error": "no job manager"}
                body = (json.dumps(doc, default=str) + "\n").encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/":
                body = b"raft_tla_tpu_torch metrics: /metrics /flight /jobs\n"
                ctype = "text/plain"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except BrokenPipeError:
            pass
        except Exception as e:                      # pragma: no cover
            try:
                self.send_error(500, str(e)[:200])
            except Exception:
                pass

    def log_message(self, fmt, *args):
        pass      # scrapes every few seconds must not spam stderr


class MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    registry = None
    flight = None
    #: Zero-arg callable returning the /jobs document; None (a check run
    #: has no job registry) answers ``{"ok": false}``.
    jobs_provider = None
    labels: Optional[Dict[str, str]] = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # peer -> monotonic ts of its last recorded watch_attach (the
        # per-peer attach rate limit in the /flight handler).
        self.seen_watchers = {}


def serve_metrics(port: int, registry, flight=None,
                  host: str = "127.0.0.1",
                  labels: Optional[Dict[str, str]] = None,
                  jobs_provider=None) -> MetricsHTTPServer:
    """Create (not start) the listener; port 0 picks an ephemeral port
    (``server_address[1]``).  Unauthenticated, loopback by default."""
    srv = MetricsHTTPServer((host, port), _MetricsHandler)
    srv.registry = registry
    srv.flight = flight
    srv.jobs_provider = jobs_provider
    srv.labels = labels if labels is not None else default_labels()
    return srv


def start_metrics_server(port: int, registry, flight=None,
                         host: str = "127.0.0.1",
                         labels: Optional[Dict[str, str]] = None,
                         jobs_provider=None
                         ) -> Tuple[MetricsHTTPServer, threading.Thread]:
    """serve_metrics + a daemon thread running it; returns (server,
    thread).  Callers ``server.shutdown()`` when the run ends (or just
    exit — daemon threads don't pin the process)."""
    srv = serve_metrics(port, registry, flight=flight, host=host,
                        labels=labels, jobs_provider=jobs_provider)
    t = threading.Thread(target=srv.serve_forever,
                         name="metrics-http", daemon=True)
    t.start()
    return srv, t
