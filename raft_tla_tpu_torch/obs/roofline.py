"""Roofline: per-stage traffic floors, priced against the card's
bandwidth, with the fusion advisor.

The floors come from a provenance walk of the chunk profiler's own
stages (``obs/profile.py build_stage_chain``), as the JAX package's
``obs/roofline.py`` walks its stage programs' jaxprs: each stage is
traced by ``make_fx`` in fake mode at the engine's B and K on the CPU
(nothing is allocated at those sizes and nothing runs), and its aten
graph is evaluated by ``analysis/interp.py eval_graph`` under
:class:`TrafficDomain`.  The byte model is a floor: every stage input is
read once, or only through its windows when it is only reached through
gathers or views; every stage output is written once; an input written
in place (``zero_``, ``copy_``, a kernel's own writes) counts its
window, or its extent; an input returned unchanged counts nothing;
intermediates are free.  ``launches`` counts the stage's device ops:

- aliases (``view``, ``reshape``, ``squeeze``, ``unsqueeze``, ``alias``,
  ``detach``, ``lift_fresh_copy``) and allocations (``empty*``) are free;
- ``expand`` reads its source and is free (the JAX broadcast);
- views of part of a tensor (``slice``, ``select``, ``narrow``, ``split``,
  ``unbind``, ``permute``, ``transpose``, ...) are free too, as on the
  card, where a view launches nothing: the view carries its bytes of the
  input, and the op that reads it reads that window.  (In XLA a static
  ``slice`` or a ``transpose`` is an op that reads its operand in full:
  the one rule where the port departs from the JAX walk,
  ``tests/test_torch_roofline.py`` pins it);
- gathers (``index.Tensor``, ``index_select``, ``gather``, ``take``) read
  the output's bytes of operand 0 and their indices in full;
- read-modify-write windows (``index_put``, ``index_copy``, ``index_add``,
  ``scatter``, ``scatter_add``, ``scatter_reduce``, ``slice_scatter``,
  ``select_scatter``, in place or not) read and write the update's
  bytes, and the result aliases operand 0;
- a hand-written kernel is one launch that reads its operands in full
  and writes the operands it writes in full (the JAX ``pallas_call``
  rule): while walking, each kernel's plain version is replaced by an
  opaque ``raft_walk`` node (``kernels_as_leaves``);
- every other op reads its operands in full and is one device op.

The stage graphs hold no loops (the tracer unrolls Python loops) and no
collectives, so ``while_launches``, ``collectives`` and
``collectives_in_loop`` are 0; the keys are the JAX module's.  A stage's floor assumes nothing of the
data: it is the traffic of the traced program, whatever the batch holds.

The hand byte counts below (``compact_bytes`` ... ``lane_bytes``) serve
another purpose: ``chip_smoke.py`` prices each kernel's bound with them
from the live counts of a real batch (lanes live, distinct, new and
enqueued), which a walk of the traced program cannot know.

``achieved fraction = (floor bytes / measured stage seconds) / peak``;
``headroom = measured - floor time`` is what fusion can win back;
``advise`` ranks the stages by ``launches x per-launch overhead +
headroom``.  ``peak_bandwidth`` reads the card's name (``RAFT_PEAK_GBPS``
overrides); the ``source`` field says which figure was used.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import sys
from typing import Dict, Optional, Tuple

import torch

#: Peak memory bandwidth by card-name substring (bytes/s), matched
#: case-insensitively against ``torch.cuda.get_device_name``; the first
#: match wins.  NVIDIA data sheets.
PEAK_BW_TABLE = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),          # H100 SXM, HBM3
)

#: Off the card: dual-channel DDR4-3200 class, marked "assumed".
CPU_ASSUMED_BW = 51.2e9


def peak_bandwidth(device=None) -> Dict[str, object]:
    """``{"bytes_per_sec", "source"}`` for the card (the first visible
    one unless ``device`` names another, or the CPU).  An unknown card
    gets the assumed figure with a source that says so."""
    env = os.environ.get("RAFT_PEAK_GBPS")
    if env:
        try:
            return {"bytes_per_sec": float(env) * 1e9,
                    "source": "RAFT_PEAK_GBPS override"}
        except ValueError:
            print(f"perf: ignoring malformed RAFT_PEAK_GBPS={env!r} "
                  f"(want GB/s as a number)", file=sys.stderr)
    kind = ""
    try:
        dev = torch.device(device) if device is not None else None
        if (dev is None or dev.type == "cuda") \
                and torch.cuda.is_available():
            kind = torch.cuda.get_device_name(dev).lower()
    except Exception:
        kind = ""
    if kind:
        for sub, bw in PEAK_BW_TABLE:
            if sub in kind:
                return {"bytes_per_sec": bw,
                        "source": f"datasheet ({kind})"}
        return {"bytes_per_sec": CPU_ASSUMED_BW,
                "source": f"assumed (unknown accelerator {kind!r})"}
    return {"bytes_per_sec": CPU_ASSUMED_BW,
            "source": "assumed (cpu ddr-class)"}


# ---------------------------------------------------------------------------
# The byte counts of the kernels (chip_smoke.py's bounds)


def compact_bytes(b: int, g: int, k: int, total: int) -> int:
    """B3: the [b, g] mask once, kspread only in the dead slots, lane_id,
    kvalid and (P, total) written once."""
    return b * g + (k - total) * 4 + k * 4 + k + 8


def insert_bytes(n: int, n_distinct: int, n_new: int) -> int:
    """B1: queries + valid + is_new + fail, one 32-byte sector read a
    distinct valid key (a duplicate finds its key where the first lane
    did) and one written a claimed slot."""
    return n * (8 + 1 + 1) + 1 + 32 * n_distinct + 32 * n_new


def fused_tail_bytes(n: int, n_distinct: int, n_new: int, n_enq: int,
                     sw: int) -> int:
    """B2: the insert's bytes, enq_ok and the count, and each enqueued
    row read once and written once."""
    return insert_bytes(n, n_distinct, n_new) + n + 4 + 2 * n_enq * sw


def enqueue_bytes(k: int, n_enq: int, sw: int) -> int:
    """B5: the mask once, each enqueued row read once and written once,
    the count."""
    return k + 2 * n_enq * sw + 4


def salt_bytes(dims) -> int:
    """The delta fingerprint's salt tables."""
    return 4 * (2 + 2 * (7 * dims.n_servers + 2 * dims.n_servers
                         * dims.max_log + 2 * dims.n_servers ** 2)
                + 2 * dims.msg_width)


def lane_bytes(dims, total: int) -> int:
    """Written on each live lane: its row and six scalars."""
    from ..models.schema import state_width
    return total * (state_width(dims) + 8 * 5 + 1)


def front_bytes(dims, b: int, k: int, total: int) -> int:
    """B4, one front call.  Read: the parent rows, valid, kspread in the
    dead slots and the salt tables; written: the three [b, G] masks,
    (P, total), lane_id, kvalid and on each live lane its row and six
    scalars (dead lanes are left unwritten by contract)."""
    from ..models.schema import state_width
    sw, g = state_width(dims), dims.n_instances
    return (b * sw + b + (k - total) * 4 + salt_bytes(dims) + 3 * b * g + 8
            + k * 4 + k + lane_bytes(dims, total))


# ---------------------------------------------------------------------------
# The provenance traffic walk (an analysis/interp.py eval_graph domain)

#: Aliases: the same elements under another shape, at no cost.
_ALIAS_OPS = frozenset(("view", "_unsafe_view", "reshape", "squeeze",
                        "unsqueeze", "alias", "detach", "lift_fresh_copy"))
#: Views of part of a tensor (or of its elements in another order): no
#: launch; the view carries its root, and whoever reads it reads its
#: bytes of that root.
_WINDOW_VIEWS = frozenset(("slice", "select", "narrow", "permute",
                           "transpose", "t", "diagonal", "as_strided",
                           "unfold", "split", "split_with_sizes", "unbind",
                           "chunk"))
#: Broadcasts: read their source, fused for free.
_BROADCASTS = frozenset(("expand",))
#: Gathers: the output's bytes of operand 0, the indices in full.
_WINDOW_READ = frozenset(("index", "index_select", "gather", "take"))
#: Read-modify-write windows of operand 0: the update's bytes read and
#: written, the result aliases operand 0.
_WINDOW_RMW = frozenset((
    "index_put", "index_put_", "index_copy", "index_copy_", "index_add",
    "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "slice_scatter", "select_scatter"))
#: In-place writes that do not read what they overwrite.
_OVERWRITE = frozenset(("copy_", "fill_", "zero_"))
#: Allocations: no launch, nothing read.
_ALLOC = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided"))
#: The namespace of the kernels' stand-ins (``kernels_as_leaves``).
LEAF_NAMESPACE = "raft_walk"


class _Src:
    """Provenance of one value: the stage input it aliases (``root``),
    the bytes of that input it covers when it is a window of it
    (``window``; None for the whole), and the window bytes a functional
    read-modify-write chain wrote into that input (``written``)."""

    __slots__ = ("root", "window", "written")

    def __init__(self, root=None, window=None, written=0):
        self.root, self.window, self.written = root, window, written


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _tensor_args(args, kwargs) -> list:
    out = []

    def walk(x):
        if isinstance(x, _Src):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
    walk(args)
    walk(list(kwargs.values()))
    return out


def _indexed_shape(self_shape, indices) -> Tuple[int, ...]:
    """The shape ``self[indices]`` reads (or ``index_put`` writes): the
    index tensors' broadcast shape, then the dimensions left unindexed."""
    idx = [tuple(i.shape) if i is not None else None for i in indices]
    bshape = torch.broadcast_shapes(*[s for s in idx if s is not None])
    rest = [d for d, i in zip(self_shape, idx + [None] * len(self_shape))
            if i is None]
    return tuple(bshape) + tuple(rest)


class TrafficDomain:
    """Domain for :func:`analysis.interp.eval_graph` that gathers a
    stage's traffic floor: which stage inputs are read in full and which
    only through windows, the bytes written into stage inputs (in place,
    or through a read-modify-write window), and the device ops."""

    def __init__(self):
        self.full_read = set()                  # roots read in full
        self.win_read: Dict[int, int] = {}      # root -> window bytes
        self.full_written = set()               # roots written in full
        self.win_written: Dict[int, int] = {}   # root -> window bytes
        self.launches = 0                       # device ops (views free)
        self.notes = set()

    # -- domain protocol ----------------------------------------------
    def lift(self, x):
        return x if isinstance(x, _Src) else _Src()

    # -- accumulators --------------------------------------------------
    def _read_full(self, v):
        if v.root is None:
            return
        if v.window is None:
            self.full_read.add(v.root)
        else:
            self.win_read[v.root] = self.win_read.get(v.root, 0) + v.window

    def _read_win(self, v, nbytes):
        if v.root is not None:
            self.win_read[v.root] = self.win_read.get(v.root, 0) + nbytes

    def _write(self, v, nbytes=None):
        """``nbytes`` of ``v``'s root written (its whole extent when
        None)."""
        if v.root is None:
            return
        n = nbytes if nbytes is not None else v.window
        if n is None:
            self.full_written.add(v.root)
        else:
            self.win_written[v.root] = self.win_written.get(v.root, 0) + n

    # -- op rules ------------------------------------------------------
    def apply(self, node, args, kwargs):
        from ..analysis.interp import _out_meta, _packet
        val = node.meta.get("val")
        metas = _out_meta(node)
        many = isinstance(val, (tuple, list))

        def outs(make):
            got = [make(i, shape, dtype)
                   for i, (shape, dtype) in enumerate(metas)]
            return type(val)(got) if many else got[0]

        def fresh(*_):
            return _Src()

        if getattr(node.target, "namespace", None) == LEAF_NAMESPACE:
            # One kernel launch: block windows are invisible here, so
            # every operand counts at full extent, and an operand it
            # writes is written in full (the JAX pallas_call rule).
            self.launches += 1
            self.notes.add(f"kernel leaf: {node.target._schema.name}")
            schema = node.target._schema.arguments
            for i, a in enumerate(args):
                if not isinstance(a, _Src):
                    continue
                self._read_full(a)
                info = schema[i].alias_info
                if info is not None and info.is_write:
                    self._write(a)
            self.notes.add("kernel traffic at operand granularity")
            return outs(fresh)
        name = _packet(node)
        tens = _tensor_args(args, kwargs)
        if name in _ALIAS_OPS:
            return args[0]
        if name in _WINDOW_VIEWS:
            src = args[0]
            if src.root is None:
                return outs(fresh)
            return outs(lambda i, shape, dtype: _Src(
                src.root, _nbytes(shape, dtype)))
        if name in _BROADCASTS:
            self._read_full(args[0])
            return outs(fresh)
        if name in _ALLOC:
            return outs(fresh)
        if name in _WINDOW_READ:
            self._read_win(args[0], _nbytes(*metas[0]))
            for v in tens[1:]:
                self._read_full(v)
            self.launches += 1
            return outs(fresh)
        if name in _WINDOW_RMW:
            nb = self._update_bytes(name, node)
            dst = args[0]
            self._read_win(dst, nb)
            for v in tens[1:]:
                self._read_full(v)
            self.launches += 1
            if name.endswith("_"):
                self._write(dst, nb)
                return dst
            return _Src(dst.root, dst.window, dst.written + nb) \
                if dst.root is not None else _Src()
        schema = getattr(node.target, "_schema", None)
        first = schema.arguments[0].alias_info if schema is not None \
            and schema.arguments else None
        if first is not None and first.is_write:
            # In place into operand 0: its extent (window or whole)
            # written; it is read too unless the op overwrites it.
            dst = args[0]
            for v in tens[1:]:
                self._read_full(v)
            if name not in _OVERWRITE:
                self._read_full(dst)
            self._write(dst)
            self.launches += 1
            return dst
        for v in tens:
            self._read_full(v)
        self.launches += 1
        return outs(fresh)

    @staticmethod
    def _update_bytes(name, node) -> int:
        """The bytes of operand 0 that a read-modify-write op updates."""
        base = name.rstrip("_")
        a0 = node.args[0].meta["val"]
        if base == "index_put":
            idx = [i.meta["val"] if i is not None else None
                   for i in node.args[1]]
            return _nbytes(_indexed_shape(a0.shape, idx), a0.dtype)
        if base in ("index_copy", "index_add"):
            return _nbytes(node.args[3].meta["val"].shape, a0.dtype)
        if base in ("scatter", "scatter_add", "scatter_reduce"):
            return _nbytes(node.args[2].meta["val"].shape, a0.dtype)
        # slice_scatter / select_scatter: the source.
        return _nbytes(node.args[1].meta["val"].shape, a0.dtype)


def graph_traffic(gm, inputs) -> dict:
    """Traffic floor of one traced stage graph: ``{"bytes_read",
    "bytes_written", "launches", "while_launches", "collectives",
    "collectives_in_loop", "notes"}`` (the notes name the kernel leaves).
    ``inputs`` are the graph's placeholder tensors in order (real or
    fake: only their shapes and dtypes are read).  Nothing runs: the
    graph is evaluated under :class:`TrafficDomain`."""
    from ..analysis.interp import eval_graph
    dom = TrafficDomain()
    outs = eval_graph(gm, [_Src(i) for i in range(len(inputs))], dom)
    out_nodes = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    if not isinstance(out_nodes, (list, tuple)):
        out_nodes = [out_nodes]
    full = [_nbytes(t.shape, t.dtype) for t in inputs]
    bytes_read = 0
    for i, nb in enumerate(full):
        if i in dom.full_read:
            bytes_read += nb
        else:
            bytes_read += min(nb, dom.win_read.get(i, 0))
    # A functional read-modify-write chain that reaches an output wrote
    # its windows into that input (the JAX carry-through rule).
    chained: Dict[int, int] = {}
    bytes_written = 0
    for o, n in zip(outs, out_nodes):
        if o.root is None:
            v = n.meta["val"]
            bytes_written += _nbytes(v.shape, v.dtype)
        elif o.written:
            chained[o.root] = max(chained.get(o.root, 0), o.written)
    for i, nb in enumerate(full):
        if i in dom.full_written:
            bytes_written += nb
        else:
            bytes_written += min(nb, dom.win_written.get(i, 0)
                                 + chained.get(i, 0))
    return {"bytes_read": bytes_read, "bytes_written": bytes_written,
            "launches": dom.launches, "while_launches": 0,
            "collectives": 0, "collectives_in_loop": 0,
            "notes": sorted(dom.notes)}


# ---------------------------------------------------------------------------
# The kernels' stand-ins


_LEAF_SCHEMAS = {
    "compact": "compact(Tensor en, Tensor kspread) -> "
               "(Tensor, Tensor, Tensor)",
    "fpset_insert": "fpset_insert(Tensor(a!) table, Tensor(b!) size, "
                    "Tensor keys, Tensor valid) -> (Tensor, Tensor)",
    "fused_tail": "fused_tail(Tensor(a!) table, Tensor(b!) size, "
                  "Tensor keys, Tensor valid, Tensor krows, Tensor enq_ok, "
                  "Tensor(c!) qnext, Tensor next_count) -> "
                  "(Tensor, Tensor, Tensor)",
    "enqueue": "enqueue(Tensor(a!) qnext, Tensor next_count, Tensor krows, "
               "Tensor enq) -> Tensor",
    "chunk_front": "chunk_front(Tensor rows, Tensor valid, int K, int G, "
                   "int sw) -> (" + ", ".join(["Tensor"] * 13) + ")",
    "chunk_front_build": "chunk_front_build(Tensor rows, Tensor lane_id, "
                         "Tensor mask, Tensor(a!) krows, "
                         "Tensor(b!) cons_ok, Tensor(c!) inv) -> ()",
}


def _leaf_outputs(name, *a):
    """The outputs each kernel's wrapper allocates on the card, as empty
    tensors of their shapes and dtypes."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=a[0].device)

    b8, i32, i64 = torch.bool, torch.int32, torch.int64
    if name == "compact":
        K = a[1].shape[0]
        return empty(2, i32), empty(K, i32), empty(K, b8)
    if name == "fpset_insert":
        return empty(a[2].shape[0], b8), empty((), b8)
    if name == "fused_tail":
        return empty(a[2].shape[0], b8), empty((), b8), empty(1, i32)
    if name == "enqueue":
        return empty(1, i32)
    if name == "chunk_front_build":
        return None
    rows, _valid, K, G, sw = a
    B = rows.shape[0]
    return (empty((B, G), b8), empty((B, G), b8), empty((B, G), b8),
            empty(2, i32), empty(K, i32), empty(K, b8), empty(K, i64),
            empty(K, i64), empty((K, sw), torch.uint8), empty(K, b8),
            empty(K, i64), empty(K, i64), empty(K, i64))


@functools.cache
def _leaf_library():
    """The ``raft_walk`` operators, one a kernel: opaque nodes in a trace
    whose fake versions only allocate the kernel's outputs.  Registered
    on the first walk; the library object keeps them alive."""
    lib = torch.library.Library(LEAF_NAMESPACE, "DEF")
    for name, schema in _LEAF_SCHEMAS.items():
        lib.define(schema)

        def never(*a, _name=name, **k):
            raise RuntimeError(f"{LEAF_NAMESPACE}::{_name} stands for a "
                               "kernel in a traffic walk and never runs")
        lib.impl(name, never, "CompositeExplicitAutograd")
        torch.library.register_fake(
            f"{LEAF_NAMESPACE}::{name}",
            lambda *a, _name=name: _leaf_outputs(_name, *a), lib=lib)
    return lib


def _leaves():
    """``{label: stand-in}`` for the sites of ``analysis/lint.py
    kernel_sites``, each with its plain version's signature."""
    _leaf_library()
    ops = getattr(torch.ops, LEAF_NAMESPACE)

    def count_tensor(next_count, like):
        if isinstance(next_count, torch.Tensor):
            return next_count.view(1)
        return torch.full((1,), int(next_count), dtype=torch.int32,
                          device=like.device)

    def compact(en, K, kspread, p_cap=None):
        return tuple(ops.compact(en, kspread))

    def insert(seen, keys, valid):
        return tuple(ops.fpset_insert(seen.keys, seen.size, keys, valid))

    def fused_tail(seen, keys, valid, krows, enq_ok, qnext, next_count):
        is_new, fail, count = ops.fused_tail(
            seen.keys, seen.size, keys, valid, krows, enq_ok, qnext,
            count_tensor(next_count, krows))
        return is_new, fail, count[0]

    def enqueue(qnext, next_count, krows, enq):
        return ops.enqueue(qnext, count_tensor(next_count, krows), krows,
                           enq)[0]

    def front(self, rows, valid):
        from ..ops.chunk_front import FrontOut
        (en, ovf, pruned, pt, lane_id, kvalid, kh, kl, krows, cons_ok, inv,
         ph, pl) = ops.chunk_front(rows, valid, self.K, self.G, self.sw)
        return FrontOut(en=en, ovf=ovf, pruned=pruned, P=pt[0], total=pt[1],
                        lane_id=lane_id, kvalid=kvalid, kh=kh, kl=kl,
                        krows=krows, cons_ok=cons_ok, inv=inv, parent_hi=ph,
                        parent_lo=pl)

    def build(self, rows, out, mask, built=None):
        ops.chunk_front_build(rows, out.lane_id, mask, out.krows,
                              out.cons_ok, out.inv)
        return out.cons_ok

    return {"compact": compact, "fpset_insert": insert,
            "fused_tail": fused_tail, "enqueue": enqueue,
            "chunk_front": front, "chunk_front_build": build}


@contextlib.contextmanager
def kernels_as_leaves():
    """While walking, each kernel's plain version (the sites of
    ``analysis/lint.py kernel_sites``) is replaced by its stand-in: one
    opaque ``raft_walk`` node.  Neither a kernel nor its plain version
    runs; the sites are put back after the block."""
    from ..analysis.interp import TRACE_LOCK
    from ..analysis.lint import kernel_sites
    leaves = _leaves()
    saved = []
    with TRACE_LOCK:
        try:
            for obj, attr, label in kernel_sites():
                saved.append((obj, attr, getattr(obj, attr)))
                setattr(obj, attr, leaves[label])
            yield
        finally:
            for obj, attr, orig in saved:
                setattr(obj, attr, orig)


# ---------------------------------------------------------------------------
# The stage floors: the walk over the profiler's stages

#: Slots of the seen set a walk traces with (the JAX ``stage_traffic``'s
#: default ``seen_capacity``): a kernel leaf reads it at full extent.
WALK_SEEN_CAPACITY = 1 << 14

_WALKS: Dict[tuple, Dict[str, dict]] = {}


def _flat_stage(stage, args):
    """``(tensors, fn, rebuild)``: ``stage.fn`` over the distinct tensors
    of ``args`` (structures flattened, anything else held fixed), and
    ``rebuild(values)`` that puts the traced outputs back into the
    stage's output structure."""
    import torch.utils._pytree as pytree
    leaves, spec = pytree.tree_flatten(list(args))
    tensors, slot = [], {}
    pos = []
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            if id(x) not in slot:
                slot[id(x)] = len(tensors)
                tensors.append(x)
            pos.append((i, slot[id(x)]))
    held = {}

    def fn(*ts):
        lv = list(leaves)
        for i, j in pos:
            lv[i] = ts[j]
        res = stage.fn(*pytree.tree_unflatten(lv, spec))
        if len(stage.outs) == 1:
            res = (res,)
        out, held["spec"] = pytree.tree_flatten(list(res))
        held["leaves"] = out
        return [x for x in out if isinstance(x, torch.Tensor)]

    def rebuild(values):
        it = iter(values)
        lv = [next(it) if isinstance(x, torch.Tensor) else x
              for x in held["leaves"]]
        return pytree.tree_unflatten(lv, held["spec"])

    return tensors, fn, rebuild


def _walk(dims, B, K, pipeline, enqueue_method, ring, swarm_pipeline):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..models.schema import state_width
    from . import profile
    out: Dict[str, dict] = {}
    with kernels_as_leaves(), torch.no_grad():
        chain = profile.build_stage_chain(
            dims, B, K, "cpu", pipeline=pipeline,
            stage_kw={"enqueue_method": enqueue_method},
            swarm_pipeline=swarm_pipeline)
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            env = profile.stage_scratch(
                dims, B, K, "cpu", pipeline=pipeline,
                seen_capacity=WALK_SEEN_CAPACITY, ring=ring)
            env["rows"] = torch.empty((B, state_width(dims)),
                                      dtype=torch.uint8)
            env["valid"] = torch.empty(B, dtype=torch.bool)
        env["k"] = 0
        for stage in chain:
            tensors, fn, rebuild = _flat_stage(
                stage, [env[k] for k in stage.ins])
            gm = make_fx(fn, tracing_mode="fake")(*tensors)
            row = graph_traffic(gm, tensors)
            row["bytes_total"] = row["bytes_read"] + row["bytes_written"]
            out[stage.name] = row
            res = next(n for n in gm.graph.nodes if n.op == "output").args[0]
            env.update(zip(stage.outs, rebuild(
                [n.meta["val"] for n in res])))
    return out


def stage_traffic(dims, B: int, K: int, *, pipeline: str = "v4",
                  ring: int = 16, enqueue_method: str = "fused",
                  swarm_pipeline: str = "v2") -> Dict[str, dict]:
    """``{stage: {bytes_read, bytes_written, bytes_total, launches,
    while_launches, collectives, collectives_in_loop, notes}}``
    for the chunk profiler's stages (``obs/profile.py``
    ``build_stage_chain``), keyed as its stage means: each stage traced
    by ``make_fx`` in fake mode at ``B`` and ``K`` on the CPU (no memory
    of those sizes is taken, nothing runs) and walked under
    :class:`TrafficDomain`.  ``enqueue_method`` names the tail (v1 takes
    the split one for "fused"); ``ring`` and ``swarm_pipeline`` are the
    swarm's.  The stages are built as the JAX profiler's are: no
    constraint, no invariants, no trace records, no POR table.  Memoised
    per ``(dims, B, K, pipeline, enqueue_method, ring, swarm_pipeline)``:
    a warm engine or a served job pays the trace once."""
    if pipeline == "v1":
        from ..ops.pipeline_v1 import resolve_method
        enqueue_method = resolve_method(enqueue_method)[0]
    if pipeline == "swarm":
        enqueue_method = None
    else:
        ring = swarm_pipeline = None
    key = (dims, int(B), int(K), pipeline, enqueue_method, ring,
           swarm_pipeline)
    from ..analysis.interp import TRACE_LOCK
    with TRACE_LOCK:
        got = _WALKS.get(key)
        if got is None:
            if pipeline not in ("v1", "v3", "v4", "swarm"):
                raise ValueError(
                    f"no stage traffic for pipeline {pipeline!r}")
            got = _WALKS[key] = _walk(dims, int(B), int(K), pipeline,
                                      enqueue_method, ring, swarm_pipeline)
    return copy.deepcopy(got)


def walked_floors(engine: str, dims, B: int, K: int,
                  **kw) -> Optional[Dict[str, dict]]:
    """``stage_traffic`` for an engine's perf block, or None with a
    warning on stderr naming ``engine`` when the walk fails: a roofline
    that cannot be built never fails the engine."""
    try:
        return stage_traffic(dims, B, K, **kw)
    except Exception as e:
        print(f"perf: {engine} roofline walk unavailable "
              f"({type(e).__name__}: {e}); continuing without",
              file=sys.stderr)
        return None


# ---------------------------------------------------------------------------
# Roofline rows and the fusion advisor (the JAX module's)


def build_roofline(traffic: Dict[str, dict],
                   stage_means: Optional[Dict[str, float]],
                   peak: Dict[str, object]) -> Dict[str, dict]:
    """Join the floors with the chunk profiler's measured stage means.
    Rows without a measurement keep their floors and launches with null
    achieved fields."""
    bw = float(peak["bytes_per_sec"])
    means = stage_means or {}
    rows: Dict[str, dict] = {}
    for stage, t in traffic.items():
        floor_s = t["bytes_total"] / bw if bw else None
        mean_s = means.get(stage)
        row = {
            "bytes_read": t["bytes_read"],
            "bytes_written": t["bytes_written"],
            "bytes_total": t["bytes_total"],
            "launches": t["launches"],
            "floor_seconds": round(floor_s, 9) if floor_s else floor_s,
            "mean_seconds": (round(mean_s, 6) if mean_s is not None
                             else None),
            "achieved_gbps": None,
            "bandwidth_fraction": None,
            "headroom_seconds": None,
            "notes": t.get("notes", []),
        }
        if mean_s:
            achieved = t["bytes_total"] / mean_s
            row["achieved_gbps"] = round(achieved / 1e9, 3)
            row["bandwidth_fraction"] = round(achieved / bw, 6) if bw \
                else None
            row["headroom_seconds"] = round(
                max(0.0, mean_s - (floor_s or 0.0)), 6)
        rows[stage] = row
    return rows


def advise(rows: Dict[str, dict], overhead_seconds: float) -> dict:
    """Rank the stages by the time fusion could win back (``launches x
    per-launch overhead + headroom``) and name the top one; a stage with
    no measured mean scores on its launches alone (``basis`` says
    which)."""
    ranking = []
    for stage, row in rows.items():
        tax = row["launches"] * overhead_seconds
        headroom = row["headroom_seconds"]
        score = tax + (headroom or 0.0)
        ranking.append({
            "stage": stage,
            "score_seconds": round(score, 6),
            "launch_tax_seconds": round(tax, 6),
            "headroom_seconds": headroom,
            "launches": row["launches"],
            "bandwidth_fraction": row["bandwidth_fraction"],
            "basis": ("measured+model" if headroom is not None
                      else "launch-model-only"),
        })
    ranking.sort(key=lambda r: (-r["score_seconds"], r["stage"]))
    if not ranking:
        return {"ranking": [], "top": None, "verdict": "no stages"}
    top = ranking[0]
    frac = top["bandwidth_fraction"]
    verdict = (
        f"fuse '{top['stage']}' next: {top['launches']} device ops/batch "
        f"(~{top['launch_tax_seconds'] * 1e3:.3f} ms launch tax)"
        + (f", {top['headroom_seconds'] * 1e3:.3f} ms above the "
           f"bandwidth floor ({frac:.1%} of peak achieved)"
           if top["headroom_seconds"] is not None and frac is not None
           else ", unmeasured headroom"))
    return {"ranking": ranking, "top": top["stage"], "verdict": verdict}
