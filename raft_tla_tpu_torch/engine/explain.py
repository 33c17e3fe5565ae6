"""Counterexample explainer: TLC's decoded error trace, three ways.

The JAX package's ``engine/explain.py``, kept as the port's own copy.  A
violation leaves the engine a fingerprint, the trace store's predecessor
chain and ``replay()``, which re-runs the successor function along the
chain and yields ``[(action id, PyState)]`` root first.  This module
renders that the way TLC users read it:

- :func:`decode_steps`: replay output -> step records, each with its
  action label (``dims.describe_instance``), the decoded state
  (``models/pystate.state_fields``) and the fields changed since the step
  before (``diff_states``);
- :func:`render_text`: TLC's numbered-state error trace (``State 1:
  <Initial predicate>`` ...), each state printed by ``format_state``
  under a ``changed:`` line;
- :func:`render_json` / :func:`render_html`: the same trace as a JSON
  document and as one standalone HTML page;
- :func:`write_counterexample`: ``<workdir>/counterexample.txt`` and
  ``.json``, written atomically; the engines call it on every traced
  violation and stamp the path into ``run_end``;
- :func:`export_graph`: for small spaces (``cap``-bounded), the whole
  reached graph from the trace store (``export()``) as DOT or GraphML.

CLI: ``python3 -m raft_tla_tpu_torch explain <cfg>`` and ``check``'s
violation printout.  Reads finished runs only.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..models.pystate import PyState, diff_states, format_state, state_fields

#: Default node cap for full-graph export — past this a DOT file stops
#: being readable or layoutable, and the export loop stops being cheap.
GRAPH_CAP_DEFAULT = 50_000


def action_label(g: int, dims) -> str:
    """TLC's angle-bracket action name for a replay step (-1 = root)."""
    return "Initial predicate" if g < 0 else dims.describe_instance(g)


def decode_steps(steps: List[Tuple[int, PyState]], dims) -> List[dict]:
    """Replay output -> structured, JSON-able step records (root first).

    Each record: ``index`` (1-based, TLC numbering), ``action`` /
    ``action_id``, ``state`` (the canonical ``state_fields`` view), and
    ``changed`` (the ``diff_states`` delta against the previous step;
    ``{}`` for the root)."""
    out = []
    prev: Optional[PyState] = None
    for idx, (g, st) in enumerate(steps, 1):
        out.append({
            "index": idx,
            "action_id": int(g),
            "action": action_label(g, dims),
            "state": state_fields(st, dims),
            "changed": diff_states(prev, st, dims) if prev is not None
            else {},
        })
        prev = st
    return out


def _fmt_changed(changed: dict) -> List[str]:
    parts = []
    for k, v in changed.items():
        if k.startswith("messages."):
            parts.append(f"{k}: {'; '.join(v)}")
        else:
            parts.append(f"{k}: {v[0]} -> {v[1]}")
    return parts


def render_text(steps: List[Tuple[int, PyState]], dims,
                violation=None) -> str:
    """TLC-style numbered error trace.  ``violation`` (an engine
    ``Violation`` or None) heads the block the way TLC's "Error:
    Invariant ... is violated" does."""
    lines = []
    if violation is not None:
        lines.append(f"Error: Invariant {violation.invariant} is "
                     f"violated (fingerprint "
                     f"{violation.fingerprint:#018x}).")
        lines.append("Error: The behavior up to this point is:")
    prev: Optional[PyState] = None
    for idx, (g, st) in enumerate(steps, 1):
        lines.append(f"State {idx}: <{action_label(g, dims)}>")
        if prev is not None:
            changed = diff_states(prev, st, dims)
            if changed:
                lines.append("  changed: "
                             + "; ".join(_fmt_changed(changed)))
        lines.append(format_state(st, dims))
        lines.append("")
        prev = st
    return "\n".join(lines).rstrip() + "\n"


def render_json(steps: List[Tuple[int, PyState]], dims,
                violation=None) -> dict:
    doc = {
        "counterexample": True,
        "length": len(steps),
        "depth": max(0, len(steps) - 1),
        "states": decode_steps(steps, dims),
    }
    if violation is not None:
        doc["invariant"] = violation.invariant
        doc["fingerprint"] = hex(violation.fingerprint)
    return doc


_HTML_HEAD = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font-family: ui-monospace, monospace; margin: 2em;
        background: #fafafa; color: #1a1a1a; }}
h1 {{ font-size: 1.1em; }}
.err {{ color: #b00020; font-weight: bold; }}
.step {{ border: 1px solid #ddd; border-radius: 6px; background: #fff;
         margin: 0.8em 0; padding: 0.6em 1em; }}
.act {{ font-weight: bold; color: #0b57d0; }}
.chg {{ color: #7a5c00; margin: 0.3em 0; }}
pre {{ margin: 0.4em 0 0 0; white-space: pre-wrap; }}
</style></head><body>
"""


def render_html(steps: List[Tuple[int, PyState]], dims,
                violation=None, title="counterexample") -> str:
    """Standalone single-file HTML rendering (no external assets — the
    artifact must open from a CI artifacts tab or an email)."""
    import html as _html
    out = [_HTML_HEAD.format(title=_html.escape(title))]
    out.append(f"<h1>{_html.escape(title)}</h1>")
    if violation is not None:
        out.append(f"<p class=err>Invariant "
                   f"{_html.escape(violation.invariant)} is violated "
                   f"(fingerprint {violation.fingerprint:#018x}).</p>")
    prev: Optional[PyState] = None
    for idx, (g, st) in enumerate(steps, 1):
        out.append("<div class=step>")
        out.append(f"<div>State {idx}: <span class=act>&lt;"
                   f"{_html.escape(action_label(g, dims))}&gt;"
                   f"</span></div>")
        if prev is not None:
            changed = diff_states(prev, st, dims)
            if changed:
                out.append("<div class=chg>changed: "
                           + _html.escape(
                               "; ".join(_fmt_changed(changed)))
                           + "</div>")
        out.append(f"<pre>{_html.escape(format_state(st, dims))}</pre>")
        out.append("</div>")
        prev = st
    out.append("</body></html>\n")
    return "\n".join(out)


RENDERERS = {"text": render_text, "json": render_json, "html": render_html}


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def write_counterexample(engine, res, workdir: str,
                         basename: str = "counterexample") -> dict:
    """Render the violation's replayed trace and write
    ``<workdir>/<basename>.txt`` + ``.json`` (atomic).  Called by the
    engines at the end of every traced violating run.  Returns
    ``{"txt": path, "json": path, "depth": n}``."""
    steps = engine.replay(res.violation.fingerprint)
    txt = os.path.join(workdir, f"{basename}.txt")
    jsn = os.path.join(workdir, f"{basename}.json")
    _atomic_write(txt, render_text(steps, engine.dims,
                                   violation=res.violation))
    doc = render_json(steps, engine.dims, violation=res.violation)
    _atomic_write(jsn, json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return {"txt": txt, "json": jsn, "depth": doc["depth"]}


# ---------------------------------------------------------------------------
# Full reached-graph export (small spaces).

def _graph_edges(trace, dims):
    """The trace store's discovery records as ``(fp, parent_fp,
    action_id)`` numpy columns, first discovery of each state in record
    order, plus the root set."""
    fps, parents, actions = trace.export()
    return fps, parents, actions, set(trace.roots)


def export_graph(trace, dims, fmt: str = "dot",
                 cap: Optional[int] = GRAPH_CAP_DEFAULT) -> str:
    """The full reached state graph (one node per recorded fingerprint,
    one edge per (parent, action) discovery record — the BFS tree TLC's
    ``-dump dot`` would draw) as DOT or GraphML text.

    ``cap`` guards the export: a store larger than it raises ValueError
    (the caller sees the real size and can raise the cap deliberately);
    None disables the guard."""
    if fmt not in ("dot", "graphml"):
        raise ValueError(f"graph format must be dot/graphml, got {fmt!r}")
    n = len(trace)
    if cap is not None and n > cap:
        raise ValueError(
            f"trace store holds {n} states, over the graph-export cap "
            f"{cap}; raise the cap explicitly for a graph this big")
    fps, parents, actions, roots = _graph_edges(trace, dims)
    if fmt == "dot":
        lines = ["digraph statespace {",
                 "  node [shape=box, fontname=monospace];"]
        for fp in sorted(roots):
            lines.append(f'  "{fp:#018x}" [style=filled, '
                         f'fillcolor=lightblue, label="root\\n{fp:#x}"];')
        for fp, par, g in zip(fps.tolist(), parents.tolist(),
                              actions.tolist()):
            if g < 0:
                continue          # root records have no incoming edge
            lines.append(f'  "{par:#018x}" -> "{fp:#018x}" '
                         f'[label="{dims.describe_instance(int(g))}"];')
        lines.append("}")
        return "\n".join(lines) + "\n"
    # GraphML
    import html as _html
    out = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
        '  <key id="action" for="edge" attr.name="action" '
        'attr.type="string"/>',
        '  <key id="root" for="node" attr.name="root" '
        'attr.type="boolean"/>',
        '  <graph id="statespace" edgedefault="directed">',
    ]
    seen_nodes = set()

    def node(fp: int):
        if fp in seen_nodes:
            return
        seen_nodes.add(fp)
        r = ('<data key="root">true</data>' if fp in roots else "")
        out.append(f'    <node id="n{fp:x}">{r}</node>')

    for fp in sorted(roots):
        node(fp)
    for i, (fp, par, g) in enumerate(zip(fps.tolist(), parents.tolist(),
                                         actions.tolist())):
        node(fp)
        if g < 0:
            continue
        node(par)
        label = _html.escape(dims.describe_instance(int(g)))
        out.append(f'    <edge id="e{i}" source="n{par:x}" '
                   f'target="n{fp:x}">'
                   f'<data key="action">{label}</data></edge>')
    out.append("  </graph>")
    out.append("</graphml>")
    return "\n".join(out) + "\n"
