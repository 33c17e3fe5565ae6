"""The partial-order reduction table: its record and its admission checks.

The JAX package's analyzer (``raft_tla_tpu/analysis/por.py``, run by
``analyze --passes por --por-artifact FILE``) proves per action instance
whether it is a valid singleton ample set and writes a versioned,
fingerprinted ``PorTable``.  The port consumes that artifact and does not
re-derive it: this module holds only the record (``PorTable``,
``load_table``) and the engine-side admission check (``check_table``).
The fingerprint is the same sha256 over the same canonical payload, so a
table the JAX analyzer wrote is accepted here and a hand-edited one is
refused; the analyzer itself works on jaxprs and is not ported.

``ample_mask[g]``: instance ``g`` is certified wherever enabled;
``priority[g]``: which certified instance is kept when several are
enabled in one state (lowest value, then lowest ``g``); ``predicates``:
every state predicate the visibility condition was proved against.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple

import numpy as np

TABLE_VERSION = 2
GRANULARITY = "element"
#: The name under which a table lists the cfg's CONSTRAINT predicate.
CONSTRAINT_PREDICATE = "CONSTRAINT"


@dataclasses.dataclass
class PorTable:
    model: str
    n_instances: int
    ample_mask: np.ndarray          # [G] bool
    priority: np.ndarray            # [G] int32
    predicates: Tuple[str, ...]
    version: int = TABLE_VERSION
    granularity: str = GRANULARITY

    def __post_init__(self):
        self.ample_mask = np.asarray(self.ample_mask, bool)
        self.priority = np.asarray(self.priority, np.int32)
        if self.ample_mask.shape != (self.n_instances,) \
                or self.priority.shape != (self.n_instances,):
            raise ValueError("table arrays must be [n_instances]")

    @property
    def certified(self) -> int:
        return int(self.ample_mask.sum())

    def payload(self) -> dict:
        return {"version": self.version, "model": self.model,
                "granularity": self.granularity,
                "n_instances": self.n_instances,
                "predicates": sorted(self.predicates),
                "ample_mask": [int(b) for b in self.ample_mask],
                "priority": [int(p) for p in self.priority]}

    @property
    def fingerprint(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def to_json(self) -> dict:
        out = self.payload()
        out["fingerprint"] = self.fingerprint
        return out

    @classmethod
    def from_json(cls, d: dict) -> "PorTable":
        if d.get("version") != TABLE_VERSION \
                or d.get("granularity", GRANULARITY) != GRANULARITY:
            raise ValueError(
                f"POR table version {d.get('version')!r} "
                f"(granularity {d.get('granularity')!r}) != supported "
                f"{TABLE_VERSION}/{GRANULARITY!r} — certificates proved "
                "under a coarser footprint encoding; regenerate with "
                "`analyze --passes por`")
        table = cls(model=d["model"], n_instances=int(d["n_instances"]),
                    ample_mask=np.asarray(d["ample_mask"], bool),
                    priority=np.asarray(d["priority"], np.int32),
                    predicates=tuple(d["predicates"]))
        if d.get("fingerprint") != table.fingerprint:
            raise ValueError(
                "POR table fingerprint mismatch (edited by hand, or "
                "truncated): the certificate no longer matches its "
                "payload; regenerate with `analyze --passes por "
                "--por-artifact FILE`")
        return table

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def load_table(path: str) -> PorTable:
    with open(path) as f:
        return PorTable.from_json(json.load(f))


def check_table(table: PorTable, dims, invariant_names=None,
                has_constraint: bool = False) -> None:
    """Engine-side admission: model signature, instance count and
    predicate coverage.  ``ValueError`` on any mismatch: a reduction
    certified for another model, or for fewer predicates than the run
    checks, is never applied."""
    if table.model != repr(dims):
        raise ValueError(
            f"POR table was certified for model {table.model!r}, "
            f"engine runs {repr(dims)!r}")
    if table.n_instances != dims.n_instances:
        raise ValueError(
            f"POR table covers {table.n_instances} action instances, "
            f"model has {dims.n_instances}")
    missing = sorted(set(invariant_names or []) - set(table.predicates))
    if missing:
        raise ValueError(
            f"POR table visibility was not proved against checked "
            f"invariant(s) {missing}; certified predicates: "
            f"{sorted(table.predicates)}")
    if has_constraint and CONSTRAINT_PREDICATE not in table.predicates:
        raise ValueError(
            "POR table was certified without a CONSTRAINT predicate "
            "but the run applies one; constraint reads gate "
            "expansion and must be part of the visibility condition")
