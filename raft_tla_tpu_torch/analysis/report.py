"""Findings and the machine-readable analysis report.

Every analysis pass (effects / bounds / lint) emits :class:`Finding`
records (the JAX package's ``analysis/report.py``: the same findings
give the same JSON document); :class:`Report` aggregates them per pass, applies the allowlist,
and renders the one JSON document the ``analyze`` CLI subcommand and the
CI gate consume.  Severity policy:

- ``ERROR``   — the model/engine pair is broken or will break silently:
  a packed lane the configured state space provably overflows, integer
  wrap inside a kernel, a host sync or a dynamic shape in the traced
  chunk step, a blocking device read planted in the chunk loop.  CI
  fails on these.
- ``WARNING`` — needs a human decision but the runtime has a guard:
  unbounded-growth lanes caught by ``schema.pack_ok`` at runtime,
  un-timed host syncs in the engine loop, narrowing converts that look
  accidental.
- ``INFO``    — analysis facts worth surfacing (fixpoint round counts,
  non-inductive interval notes, intentional uint8 packing converts).

Allowlisting: a finding is identified by ``code`` or ``code:qualifier``
(the qualifier is the field/site the finding anchors to).  ``analyze
--allow code[:qualifier]`` downgrades matching ERRORs to WARNING and
marks them ``allowlisted`` in the report — the finding stays visible,
it just stops gating (README "Static analysis").
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

ERROR, WARNING, INFO = "ERROR", "WARNING", "INFO"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass
class Finding:
    """One analysis result.  ``witness`` names the action instance that
    produces the reported behavior (e.g. ``"Timeout(i=0)"``) when the
    pass can point at one."""

    pass_name: str
    severity: str
    code: str                      # stable kebab-case id, e.g. lane-overflow
    message: str
    witness: Optional[str] = None
    field: Optional[str] = None    # StateBatch field / lane the finding is on
    details: Dict = dataclasses.field(default_factory=dict)
    allowlisted: bool = False

    @property
    def qualifier(self) -> Optional[str]:
        return self.field

    def to_json(self) -> dict:
        out = {"pass": self.pass_name, "severity": self.severity,
               "code": self.code, "message": self.message}
        for k in ("witness", "field"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.details:
            out["details"] = self.details
        if self.allowlisted:
            out["allowlisted"] = True
        return out


def _matches(finding: Finding, allow: str) -> bool:
    if ":" in allow:
        code, qual = allow.split(":", 1)
        return finding.code == code and finding.qualifier == qual
    return finding.code == allow


class Report:
    """Aggregated findings from one ``analyze`` run."""

    def __init__(self, model: Optional[dict] = None,
                 allowlist: Optional[List[str]] = None):
        self.model = model or {}
        self.allowlist = list(allowlist or [])
        self.findings: List[Finding] = []
        self.pass_summaries: Dict[str, dict] = {}

    def extend(self, findings: List[Finding]) -> None:
        for f in findings:
            if f.severity not in SEVERITIES:
                raise ValueError(f"unknown severity {f.severity!r}")
            if f.severity == ERROR and any(_matches(f, a)
                                           for a in self.allowlist):
                f = dataclasses.replace(f, severity=WARNING,
                                        allowlisted=True)
            self.findings.append(f)

    def summarize_pass(self, name: str, summary: dict) -> None:
        self.pass_summaries[name] = summary

    # -- readers -------------------------------------------------------
    def severity_counts(self, pass_name: Optional[str] = None) -> dict:
        counts = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            if pass_name is None or f.pass_name == pass_name:
                counts[f.severity] += 1
        return counts

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def first_witness(self, pass_name: Optional[str] = None):
        for f in self.findings:
            if f.severity == ERROR and f.witness is not None \
                    and (pass_name is None or f.pass_name == pass_name):
                return f.witness
        return None

    def to_json(self) -> dict:
        passes: Dict[str, dict] = {}
        for f in self.findings:
            p = passes.setdefault(
                f.pass_name,
                {"findings": [], "severity_counts": None, "summary": {}})
            p["findings"].append(f.to_json())
        for name, p in passes.items():
            p["severity_counts"] = self.severity_counts(name)
        for name, summary in self.pass_summaries.items():
            passes.setdefault(
                name,
                {"findings": [], "severity_counts": self.severity_counts(name),
                 "summary": {}})["summary"] = summary
        return {"model": self.model,
                "allowlist": self.allowlist,
                "passes": passes,
                "severity_counts": self.severity_counts(),
                "ok": self.ok}

    def render_text(self) -> str:
        lines = []
        for f in self.findings:
            if f.severity == INFO:
                continue
            loc = f" [{f.field}]" if f.field else ""
            wit = f" (witness: {f.witness})" if f.witness else ""
            mark = " (allowlisted)" if f.allowlisted else ""
            lines.append(
                f"{f.severity:7s} {f.pass_name}/{f.code}{loc}: "
                f"{f.message}{wit}{mark}")
        if "por" in self.pass_summaries:
            lines.append(render_por_table(self.pass_summaries["por"]))
        c = self.severity_counts()
        lines.append(f"analysis: {c[ERROR]} error(s), {c[WARNING]} "
                     f"warning(s), {c[INFO]} info note(s) — "
                     + ("OK" if self.ok else "FAILED"))
        return "\n".join(lines)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def render_por_table(summary: dict) -> str:
    """Text rendering of the POR pass summary: per-family certified /
    blocked counts, the closure-refutation verdict, and the top
    blocking ``(family, field, slot)`` triples — the precision worklist
    readable straight off ``analyze`` output, no JSON spelunking."""
    fams = summary.get("families", {})
    lines = [f"por: {summary.get('certified', 0)}/"
             f"{summary.get('n_instances', 0)} instance(s) certified"]
    if not fams:
        return "\n".join(lines)
    name_w = max(len(n) for n in fams) + 2
    header = (f"  {'family':<{name_w}}{'inst':>5} {'cert':>5} "
              f"{'closure':>8}  top blocking element")
    lines.append(header)
    for fam, d in fams.items():
        ref = d.get("closure_refutation")
        if d.get("certified") == d.get("instances"):
            closure = "proved"
        elif ref is None:
            closure = "blocked"
        elif ref.get("open"):
            closure = "open"          # precision worklist
        else:
            closure = "inherent"      # machine-checked impossibility
        top = d.get("blocking_elements") or []
        top_s = (f"{top[0]['family']} {top[0]['kind']} "
                 f"{top[0]['element']} ({top[0]['pairs']} pairs)") \
            if top else "-"
        lines.append(f"  {fam:<{name_w}}{d.get('instances', 0):>5} "
                     f"{d.get('certified', 0):>5} {closure:>8}  {top_s}")
    ref = summary.get("closure_refutation", {})
    if ref.get("ran"):
        lines.append(
            f"  closure refutation: {ref.get('witnessed', 0)} instance(s) "
            f"witnessed non-commuting, {ref.get('vacuous', 0)} provably "
            f"never enabled, {len(ref.get('open', []))} open")
    return "\n".join(lines)
