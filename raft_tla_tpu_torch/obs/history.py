"""The run-history ledger: one JSONL line a run.

The JAX package's ``obs/history.py`` (its writer and reader), kept as the
port's own copy.  ``check --history PATH`` (the HISTORY directive)
appends one entry a run with the JAX entry's keys:

- identity: ``cfg_fingerprint`` (sha256 of the cfg text),
  ``model_fingerprint`` (sha256 of ``repr(dims)``), the whole
  ``host_fingerprint`` (``obs/flight.py``: the card, its driver, CUDA,
  PyTorch) and its short ``host_key``;
- outcome: verdict, stop_reason, distinct / generated / diameter, wall
  seconds and rates;
- how it ran: pipeline and the resolved stages;
- the statespace report's summary (``obs/report.py summarize``); a swarm
  run's ``swarm`` block and hunt summary ride ``extra``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional

ENTRY_VERSION = 1

#: host_fingerprint keys that decide whether two entries' rates compare
#: (the hostname alone is not identity).
HOST_KEYS = ("cpu_model", "device_kind", "device_count", "platform",
             "torch", "cuda")


def host_key(fp: Optional[dict]) -> Optional[str]:
    """Short stable digest of the comparability-deciding fingerprint
    fields; None for a missing/empty fingerprint (legacy imports) — an
    unknown host must render as unknown, never as a real key."""
    if not fp or not any(fp.get(k) for k in HOST_KEYS):
        return None
    blob = json.dumps([fp.get(k) for k in HOST_KEYS])
    return hashlib.sha256(blob.encode()).hexdigest()[:10]


def fingerprint_text(text) -> str:
    if isinstance(text, str):
        text = text.encode()
    return hashlib.sha256(text).hexdigest()


def make_entry(kind: str, *, label: Optional[str] = None,
               cfg_text: Optional[str] = None,
               dims=None, host_fingerprint: Optional[dict] = None,
               verdict: Optional[str] = None,
               stop_reason: Optional[str] = None,
               distinct: Optional[int] = None,
               generated: Optional[int] = None,
               diameter: Optional[int] = None,
               wall_seconds: Optional[float] = None,
               distinct_per_sec: Optional[float] = None,
               generated_per_sec: Optional[float] = None,
               pipeline: Optional[str] = None,
               fused_stages: Optional[dict] = None,
               report_summary: Optional[dict] = None,
               bench: Optional[dict] = None,
               ts: Optional[float] = None,
               extra: Optional[dict] = None) -> dict:
    """One ledger line.  ``kind`` is ``check`` or ``swarm`` (the JAX
    ledger's kinds); unknown fields stay None rather than absent so every
    line has the same shape.  ``extra`` keys are merged last (they may
    not shadow the schema: a colliding key raises)."""
    out = {
        "v": ENTRY_VERSION,
        "ts": round(time.time() if ts is None else ts, 3),
        "kind": kind,
        "label": label,
        "cfg_fingerprint": (fingerprint_text(cfg_text)
                            if cfg_text is not None else None),
        "model_fingerprint": (fingerprint_text(repr(dims))
                              if dims is not None else None),
        "host_fingerprint": dict(host_fingerprint or {}) or None,
        "host_key": host_key(host_fingerprint),
        "verdict": verdict,
        "stop_reason": stop_reason,
        "distinct": distinct,
        "generated": generated,
        "diameter": diameter,
        "wall_seconds": wall_seconds,
        "distinct_per_sec": distinct_per_sec,
        "generated_per_sec": generated_per_sec,
        "pipeline": pipeline,
        "fused_stages": dict(fused_stages or {}) or None,
        "report": dict(report_summary or {}) or None,
        "bench": bench,
    }
    for k, v in (extra or {}).items():
        if k in out:
            raise ValueError(f"extra key {k!r} shadows a ledger field")
        out[k] = v
    return out


def entry_from_result(kind: str, res, *, cfg_text=None, dims=None,
                      host_fingerprint=None, label=None,
                      extra=None) -> dict:
    """Ledger entry from a finished ``EngineResult`` or ``SwarmResult``
    (the ``check --history`` writer)."""
    from .report import summarize
    wall = float(getattr(res, "wall_seconds", 0.0) or 0.0)
    verdict = ("violation" if getattr(res, "violation", None) is not None
               else "deadlock" if getattr(res, "deadlock", None)
               is not None else "ok")
    return make_entry(
        kind, label=label, cfg_text=cfg_text, dims=dims,
        host_fingerprint=host_fingerprint,
        verdict=verdict, stop_reason=res.stop_reason,
        distinct=res.distinct, generated=res.generated,
        diameter=res.diameter, wall_seconds=round(wall, 3),
        distinct_per_sec=round(res.distinct / wall, 1) if wall else None,
        generated_per_sec=round(res.generated / wall, 1) if wall else None,
        pipeline=res.pipeline or None,
        fused_stages=res.fused_stages,
        report_summary=summarize(getattr(res, "report", None)),
        extra=extra)


def append_entry(path: str, entry: dict, default=None) -> None:
    """Append one JSONL line (one O_APPEND write: concurrent appenders
    on a local filesystem interleave at line granularity)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(entry, sort_keys=True, default=default)
                + "\n")


def read_history(path: str) -> List[dict]:
    """Parse the ledger; raises FileNotFoundError/ValueError on a
    missing or corrupt file."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"run-history ledger missing: {path}")
    out = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: malformed ledger line "
                                 f"({e})")
            if not isinstance(rec, dict) or "kind" not in rec:
                raise ValueError(f"{path}:{ln}: not a ledger entry: "
                                 f"{line[:120]}")
            out.append(rec)
    return out
