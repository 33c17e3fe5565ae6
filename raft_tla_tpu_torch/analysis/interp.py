"""Abstract interpretation of the action kernels' aten graphs.

The v1 action kernels (``models/actions.py`` ``build_kernels``) are
branch-free PyTorch functions on fixed shapes, so the model can be
analyzed without running the state space: trace each family once with
``make_fx`` (real mode, on the CPU, on one parent row and ``[1, 1]``
parameters) to an aten graph, then re-evaluate that graph node by node
under an abstract domain instead of on a device.  Nothing here touches a
card.  Two domains share one evaluator (:func:`eval_graph`):

- :class:`IntervalDomain` (bounds pass): each value is an element-wise
  integer interval ``[lo, hi]`` (int64 arrays; Python integers where
  int64 arithmetic could overflow), so packed-lane bounds and integer
  wrap are decided by monotone transfer functions; parameters, literals,
  ``arange``/``scalar_tensor`` and the closures' constant tensors are
  degenerate intervals, which makes the evaluation a partial evaluation
  of the kernel (concrete where the model is concrete, abstract only
  where state flows in).
- :class:`TaintDomain` (effects pass): each value carries ELEMENT-WISE
  dependency masks per ``StateBatch`` field, split into a value-level
  half (``vdeps`` — any element may depend on the masked field
  elements) and a positional half (``pdeps`` — element ``p`` depends on
  the field only through the field element at the same flat position),
  an element-wise "may differ from input field F here" mask (``origin``
  / ``diff``), and the interval half above (``known`` where ``lo ==
  hi``), so parameter-derived index masks like ``arange(N) == i`` stay
  exact, writes stay confined to the instance's own lanes, and a gather
  whose index is a bounded range (``i * L + clamp(k, 0, L - 1)``) reads
  that range only.  Intersecting ``pdeps`` with a write's changed
  positions is what makes a point update read only its own row.

Both domains are *conservative*: an op without a rule falls back to
"depends on everything that flowed in / the full dtype range" and records
the op in ``domain.notes`` so a pass surfaces it instead of silently
claiming a proof.  An op whose tensor inputs are all known is evaluated
concretely through the op itself, as the JAX package's analyzer binds a
primitive on concrete operands.

Tracing happens once per action family (``traced_kernels``); per-instance
results come from re-running the evaluator with that instance's concrete
parameter values, the parameters ``build_expand`` feeds the same kernels.
The JAX package's ``analysis/interp.py`` walks jaxprs; this evaluator
walks ``torch.fx`` graphs of the port's own kernels, with the same two
domains and the same conservative contract.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

_I64 = np.int64
#: Magnitude below which int64 interval arithmetic cannot overflow.
_SAFE = float(1 << 62)


def _dtype_range(dtype) -> Tuple[int, int]:
    if dtype == torch.bool:
        return 0, 1
    if dtype.is_floating_point or dtype.is_complex:
        info = torch.iinfo(torch.int64)
    else:
        info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (bool, np.bool_)):
        return torch.bool
    arr = np.asarray(x)
    if arr.dtype == np.bool_:
        return torch.bool
    if arr.dtype.kind == "f":
        return torch.float64
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype


def _as_i64(arr) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype == object:
        return a.astype(_I64)
    return a.astype(_I64, copy=False)


def _exact(fn, *arrs):
    """``fn`` over int64 arrays, exactly: through Python integers where
    the int64 result could overflow (the result is then an object
    array, clipped by the domain's wrap check)."""
    arrs = [np.asarray(a) for a in arrs]
    with np.errstate(over="ignore", invalid="ignore"):
        est = fn(*(a.astype(np.float64) for a in arrs))
    if bool(np.all(np.abs(est) < _SAFE)):
        return fn(*(_as_i64(a) for a in arrs))
    return fn(*(a.astype(object) for a in arrs))


def _norm_dims(dims, ndim: int) -> Tuple[int, ...]:
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(sorted(d % ndim if ndim else 0 for d in dims))


def _out_meta(node):
    """(shape, torch dtype) of each output of ``node`` (cached on it)."""
    got = node.meta.get("_analysis_meta")
    if got is None:
        val = node.meta.get("val")
        vals = val if isinstance(val, (tuple, list)) else [val]
        got = node.meta["_analysis_meta"] = [(tuple(v.shape), v.dtype)
                                             for v in vals]
    return got


def _packet(node) -> str:
    got = node.meta.get("_analysis_op")
    if got is None:
        t = node.target
        pk = getattr(t, "_overloadpacket", None)
        got = node.meta["_analysis_op"] = (
            pk.__name__ if pk is not None
            else getattr(t, "__name__", str(t)))
    return got


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, y) for y in x)
    return fn(x)


def _leaves(x, cls) -> list:
    out = []
    if isinstance(x, (list, tuple)):
        for y in x:
            out.extend(_leaves(y, cls))
    elif isinstance(x, dict):
        for y in x.values():
            out.extend(_leaves(y, cls))
    elif isinstance(x, cls):
        out.append(x)
    return out


#: Ops whose output is the input's elements moved around, never computed
#: (evaluated on the bounds / masks / source positions through the op).
_STRUCTURAL = frozenset({
    "unsqueeze", "squeeze", "view", "reshape", "_unsafe_view", "expand",
    "slice", "select", "cat", "stack", "permute", "transpose", "t",
    "diagonal", "flip", "narrow", "clone", "alias", "detach",
    "lift_fresh_copy", "contiguous"})
#: Ops that keep every element at its flat position (value-preserving).
_IDENTITY = frozenset({"clone", "alias", "detach", "lift_fresh_copy",
                       "contiguous", "_to_copy"})
#: Factories whose values never depend on their tensor argument's values
#: (the others, ``arange`` or ``scalar_tensor``, take no tensor at all).
_LIKE = frozenset({"zeros_like", "ones_like", "full_like", "new_zeros",
                   "new_ones", "new_full"})
#: Element-wise ops: each output element from the inputs' elements at the
#: (broadcast) same position.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "neg", "abs", "minimum", "maximum",
    "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "__and__", "__or__", "__xor__",
    "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "clamp", "clamp_min", "clamp_max", "where"})
#: Reductions (value-level dependence on everything reduced).
_REDUCTIONS = frozenset({"sum", "any", "all", "amax", "amin", "max", "min",
                         "cumprod"})


def _concrete_call(node, args, kwargs, pick, dtypes):
    """Call ``node``'s op with every domain value replaced by the torch
    tensor ``pick(value)``."""
    def conv(v):
        if isinstance(v, _Value):
            return torch.from_numpy(np.ascontiguousarray(
                _as_i64(pick(v)))).to(dtypes(v))
        return v
    return node.target(*_tree_map(conv, args),
                       **{k: _tree_map(conv, w) for k, w in kwargs.items()})


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bool:
        return t.numpy().astype(_I64)
    if t.dtype.is_floating_point:
        return t.to(torch.int64).numpy()
    return np.array(t.to(torch.int64).numpy())


class _Value:
    """Base of the two domains' values (marks them inside op arguments)."""


# ---------------------------------------------------------------------------
# Shared evaluator


def _state_free(gm, n_state: int) -> frozenset:
    """Nodes of ``gm`` that depend on no state placeholder (the first
    ``n_state``): functions of the parameters and constants alone."""
    key = ("_analysis_state_free", n_state)
    got = gm.meta.get(key)
    if got is None:
        free, k = set(), 0
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                if k >= n_state:
                    free.add(node)
                k += 1
            elif node.op == "get_attr" or (
                    node.op == "call_function"
                    and all(a in free for a in node.all_input_nodes)):
                free.add(node)
        got = gm.meta[key] = frozenset(free)
    return got


def eval_graph(gm, args: list, domain, memo=None, n_state: int = 0) -> list:
    """Evaluate a traced ``torch.fx.GraphModule`` under ``domain``.
    ``args`` are domain values (or anything ``domain.lift`` accepts) for
    the placeholders, in order; returns the flattened outputs.  With a
    ``memo`` dict, the nodes that depend on no state placeholder (the
    first ``n_state``) are evaluated once per parameter row and domain
    kind across calls sharing the dict (values are never mutated)."""
    env: Dict = {}
    it = iter(args)
    free, pkey = frozenset(), None
    if memo is not None:
        free = _state_free(gm, n_state)
        pkey = (type(domain).__name__, tuple(
            np.asarray(a.lo if isinstance(a, _Value) else a).tobytes()
            for a in args[n_state:]))

    def read(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(read(x) for x in a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = domain.lift(next(it))
        elif node.op == "get_attr":
            obj = gm
            for part in node.target.split("."):
                obj = getattr(obj, part)
            env[node] = domain.lift(obj)
        elif node.op == "call_function":
            if node.target is operator.getitem:
                env[node] = read(node.args[0])[node.args[1]]
                continue
            if node in free:
                hit = memo.get((node, pkey))
                if hit is not None:
                    env[node] = hit
                    continue
            env[node] = domain.apply(node, list(read(node.args)),
                                     {k: read(v)
                                      for k, v in node.kwargs.items()})
            if node in free:
                memo[(node, pkey)] = env[node]
        elif node.op == "output":
            out = read(node.args[0])
            return list(out) if isinstance(out, (list, tuple)) else [out]
        else:
            raise ValueError(f"unsupported graph node {node.op!r}")
    raise ValueError("graph has no output node")


# ---------------------------------------------------------------------------
# Interval domain


@dataclasses.dataclass
class Interval(_Value):
    """Element-wise integer interval; ``lo``/``hi`` are int64 arrays of
    the value's shape, ``dtype`` the traced torch dtype (bools are
    0/1)."""

    lo: np.ndarray
    hi: np.ndarray
    dtype: torch.dtype
    _concrete: Optional[bool] = dataclasses.field(default=None, repr=False,
                                                  compare=False)

    @property
    def shape(self):
        return self.lo.shape

    @property
    def degenerate(self) -> np.ndarray:
        return self.lo == self.hi

    def is_concrete(self) -> bool:
        if self._concrete is None:
            self._concrete = bool(np.array_equal(self.lo, self.hi))
        return self._concrete


def _ival(lo, hi, dtype) -> Interval:
    """An interval value; its arrays are never written after this (they
    may be shared)."""
    lo = _as_i64(lo)
    hi = _as_i64(hi)
    if lo.shape != hi.shape:
        lo, hi = (np.array(x) for x in np.broadcast_arrays(lo, hi))
    elif not (lo.flags.writeable and hi.flags.writeable):
        lo, hi = np.array(lo), np.array(hi)
    return Interval(lo, hi, dtype)


def _bool_ival(must, may) -> Interval:
    return _ival(np.asarray(must, _I64), np.asarray(may, _I64), torch.bool)


def _or_upper(ha, hb):
    """Upper bound for x | y (and x ^ y) with x in [0,ha], y in [0,hb]:
    the all-ones value at the wider operand's bit length."""
    m = np.maximum(np.maximum(ha, hb), 0).astype(np.float64)
    bits = np.minimum(np.ceil(np.log2(m + 1)), 62).astype(_I64)
    return (np.int64(1) << bits) - 1


class IntervalDomain:
    """Transfer functions over element-wise intervals.  Conservative:
    every rule's output interval contains every concretely reachable
    value; an op without a rule widens to the full dtype range and is
    recorded in ``notes``.  Integer overflow of the *traced* dtype is
    recorded in ``wraps`` and the value clipped to the dtype's range
    (``widen_wraps`` widens it to the whole range instead, the sound
    choice for a domain that must not trust the clipped value)."""

    def __init__(self, widen_wraps: bool = False):
        self.notes: List[str] = []
        self.wraps: List[str] = []
        self.widen_wraps = widen_wraps

    # -- lifting -------------------------------------------------------
    def lift(self, x):
        if isinstance(x, Interval):
            return x
        dtype = _torch_dtype(x)
        if isinstance(x, torch.Tensor):
            arr = _to_np(x.detach().cpu())
        else:
            arr = np.asarray(x)
            arr = arr.astype(_I64) if arr.dtype.kind in "biu" \
                else _as_i64(np.trunc(arr))
        return _ival(arr, arr, dtype)

    def unknown(self, shape, dtype, why: str) -> Interval:
        if why not in self.notes:
            self.notes.append(why)
        return self.full(shape, dtype)

    @staticmethod
    def full(shape, dtype) -> Interval:
        lo, hi = _dtype_range(dtype)
        return _ival(np.full(shape, lo, _I64), np.full(shape, hi, _I64),
                     dtype)

    def _wrap_check(self, name: str, lo, hi, dtype) -> Interval:
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        if dtype == torch.int64 and lo.dtype != object \
                and hi.dtype != object:
            return _ival(lo, hi, dtype)     # exact int64: cannot exceed
        dlo, dhi = _dtype_range(dtype)
        if bool(np.any(lo < dlo)) or bool(np.any(hi > dhi)):
            self.wraps.append(name)
            if self.widen_wraps:
                return self.full(np.broadcast_shapes(lo.shape, hi.shape),
                                 dtype)
            lo = np.clip(lo, dlo, dhi)
            hi = np.clip(hi, dlo, dhi)
        return _ival(lo, hi, dtype)

    # -- dispatch ------------------------------------------------------
    def apply(self, node, args, kwargs):
        name = _packet(node)
        metas = _out_meta(node)
        vals = _leaves(args, Interval) + _leaves(kwargs, Interval)
        if name in _LIKE or all(v.is_concrete() for v in vals):
            if name not in ("empty_like", "empty"):
                return self._concrete(node, args, kwargs, name)
        if name in _STRUCTURAL:
            return self._structural(node, args, kwargs)
        rule = getattr(self, "_r_" + name.strip("_"), None)
        if rule is None:
            outs = [self.unknown(s, d, f"op:{name}") for s, d in metas]
            return outs[0] if len(outs) == 1 else tuple(outs)
        shape, dtype = metas[0]
        out = rule(node, shape, dtype, args, kwargs)
        if isinstance(out, tuple) and not isinstance(out, Interval):
            if len(out) == 2 and not isinstance(out[0], Interval):
                return self._wrap_check(name, out[0], out[1], dtype)
            return out
        return out

    def _concrete(self, node, args, kwargs, name):
        def pick(v):
            return v.lo if name not in _LIKE else np.zeros_like(v.lo)
        out = _concrete_call(node, args, kwargs, pick, lambda v: v.dtype)
        if isinstance(out, (tuple, list)):
            return tuple(self.lift(o) for o in out)
        return self.lift(out)

    def _structural(self, node, args, kwargs):
        (shape, dtype), = _out_meta(node)
        lo = _concrete_call(node, args, kwargs, lambda v: v.lo,
                            lambda v: torch.int64)
        hi = _concrete_call(node, args, kwargs, lambda v: v.hi,
                            lambda v: torch.int64)
        return _ival(lo.numpy(), hi.numpy(), dtype)

    def _operands(self, args, kwargs, shape, k: int):
        """The first ``k`` tensor-position arguments, lifted and
        broadcast to ``shape`` as (lo, hi) pairs."""
        out = []
        for a in list(args)[:k]:
            v = self.lift(a) if not isinstance(a, Interval) else a
            if v.lo.shape == shape:
                out.append((v.lo, v.hi))
            else:
                out.append((np.broadcast_to(v.lo, shape),
                            np.broadcast_to(v.hi, shape)))
        return out

    # -- arithmetic ----------------------------------------------------
    def _r_add(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        alpha = kwargs.get("alpha", 1)
        if alpha != 1:
            return self.unknown(shape, dtype, "op:add(alpha)")
        return _exact(np.add, al, bl), _exact(np.add, ah, bh)

    def _r_sub(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if kwargs.get("alpha", 1) != 1:
            return self.unknown(shape, dtype, "op:sub(alpha)")
        return _exact(np.subtract, al, bh), _exact(np.subtract, ah, bl)

    def _r_rsub(self, node, shape, dtype, args, kwargs):
        return self._r_sub(node, shape, dtype, [args[1], args[0]], kwargs)

    def _r_mul(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if dtype == torch.bool:
            return np.minimum(al, bl), np.minimum(ah, bh)
        ps = [_exact(np.multiply, x, y)
              for x in (al, ah) for y in (bl, bh)]
        return np.minimum.reduce(ps), np.maximum.reduce(ps)

    def _r_neg(self, node, shape, dtype, args, kwargs):
        (al, ah), = self._operands(args, kwargs, shape, 1)
        return _exact(np.negative, ah), _exact(np.negative, al)

    def _r_abs(self, node, shape, dtype, args, kwargs):
        (al, ah), = self._operands(args, kwargs, shape, 1)
        aa, ab = _exact(np.abs, al), _exact(np.abs, ah)
        lo = np.where((al <= 0) & (ah >= 0), 0, np.minimum(aa, ab))
        return lo, np.maximum(aa, ab)

    def _r_maximum(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        return np.maximum(al, bl), np.maximum(ah, bh)

    def _r_minimum(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        return np.minimum(al, bl), np.minimum(ah, bh)

    def _r_clamp(self, node, shape, dtype, args, kwargs):
        x = self._operands(args, kwargs, shape, 1)[0]
        lo_b = args[1] if len(args) > 1 else kwargs.get("min")
        hi_b = args[2] if len(args) > 2 else kwargs.get("max")
        lo, hi = x
        if lo_b is not None:
            b = self.lift(lo_b)
            lo = np.maximum(lo, np.broadcast_to(b.lo, shape))
            hi = np.maximum(hi, np.broadcast_to(b.hi, shape))
        if hi_b is not None:
            b = self.lift(hi_b)
            lo = np.minimum(lo, np.broadcast_to(b.lo, shape))
            hi = np.minimum(hi, np.broadcast_to(b.hi, shape))
        return lo, hi

    def _r_clamp_min(self, node, shape, dtype, args, kwargs):
        return self._r_clamp(node, shape, dtype, [args[0], args[1]], {})

    def _r_clamp_max(self, node, shape, dtype, args, kwargs):
        return self._r_clamp(node, shape, dtype, [args[0], None, args[1]],
                             {})

    def _cmp(self, args, kwargs, shape):
        return self._operands(args, kwargs, shape, 2)

    def _r_eq(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._cmp(args, kwargs, shape)
        must = (al == ah) & (bl == bh) & (al == bl)
        may = (al <= bh) & (bl <= ah)
        return _bool_ival(must, may)

    def _r_ne(self, node, shape, dtype, args, kwargs):
        eq = self._r_eq(node, shape, dtype, args, kwargs)
        return _bool_ival(1 - eq.hi, 1 - eq.lo)

    def _r_lt(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._cmp(args, kwargs, shape)
        return _bool_ival(ah < bl, al < bh)

    def _r_le(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._cmp(args, kwargs, shape)
        return _bool_ival(ah <= bl, al <= bh)

    def _r_gt(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._cmp(args, kwargs, shape)
        return _bool_ival(al > bh, ah > bl)

    def _r_ge(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._cmp(args, kwargs, shape)
        return _bool_ival(al >= bh, ah >= bl)

    # -- logic / bitwise -----------------------------------------------
    def _r_bitwise_and(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if dtype == torch.bool:
            return _bool_ival(np.minimum(al, bl), np.minimum(ah, bh))
        a_pos, b_pos = al >= 0, bl >= 0
        # x & m with m >= 0 lies in [0, m] whatever the sign of x.
        hi = np.where(a_pos & b_pos, np.minimum(ah, bh),
                      np.where(a_pos, ah, bh))
        if not bool(np.all(a_pos | b_pos)):
            return self.unknown(shape, dtype, "bitwise-and:negative")
        return np.zeros(shape, _I64), hi

    _r_and = _r_bitwise_and
    _r_logical_and = _r_bitwise_and

    def _r_bitwise_or(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if dtype == torch.bool:
            return _bool_ival(np.maximum(al, bl), np.maximum(ah, bh))
        if bool(np.all(al >= 0)) and bool(np.all(bl >= 0)):
            return np.maximum(al, bl), _or_upper(ah, bh)
        return self.unknown(shape, dtype, "bitwise-or:negative")

    _r_or = _r_bitwise_or
    _r_logical_or = _r_bitwise_or

    def _r_bitwise_xor(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if dtype == torch.bool:
            return _bool_ival(np.zeros(shape, _I64), np.ones(shape, _I64))
        if bool(np.all(al >= 0)) and bool(np.all(bl >= 0)):
            return np.zeros(shape, _I64), _or_upper(ah, bh)
        return self.unknown(shape, dtype, "bitwise-xor:negative")

    _r_xor = _r_bitwise_xor
    _r_logical_xor = _r_bitwise_xor

    def _r_bitwise_not(self, node, shape, dtype, args, kwargs):
        (al, ah), = self._operands(args, kwargs, shape, 1)
        if dtype == torch.bool:
            return _bool_ival(1 - ah, 1 - al)
        return ~ah, ~al                     # monotone decreasing

    _r_logical_not = _r_bitwise_not

    def _r_bitwise_left_shift(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        if bool(np.all(al >= 0)) and bool(np.all(bl >= 0)):
            sl, sh = np.clip(bl, 0, 64), np.clip(bh, 0, 64)

            def shl(x, s):
                return x * (2 ** s)
            return _exact(shl, al, sl), _exact(shl, ah, sh)
        return self.unknown(shape, dtype, "shift_left:negative")

    _r_lshift = _r_bitwise_left_shift

    def _r_bitwise_right_shift(self, node, shape, dtype, args, kwargs):
        (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
        sl, sh = np.clip(bl, 0, 63), np.clip(bh, 0, 63)
        return (np.minimum(al >> sl, al >> sh),
                np.maximum(ah >> sl, ah >> sh))

    _r_rshift = _r_bitwise_right_shift

    # -- selection / conversion ----------------------------------------
    def _r_where(self, node, shape, dtype, args, kwargs):
        (pl, ph), (al, ah), (bl, bh) = self._operands(args, kwargs,
                                                      shape, 3)
        deg = pl == ph
        lo = np.where(deg, np.where(pl != 0, al, bl), np.minimum(al, bl))
        hi = np.where(deg, np.where(pl != 0, ah, bh), np.maximum(ah, bh))
        return lo, hi

    def _r_to_copy(self, node, shape, dtype, args, kwargs):
        (al, ah), = self._operands(args, kwargs, shape, 1)
        if dtype == torch.bool:
            return _bool_ival((al > 0) | (ah < 0), ~((al == 0) & (ah == 0)))
        return al, ah           # narrowing: the wrap check catches it

    # -- reductions ----------------------------------------------------
    @staticmethod
    def _red_args(node, args, kwargs, ndim):
        name = _packet(node)
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if name in ("any", "all", "sum", "prod") and dims is not None \
                and not isinstance(dims, (int, list, tuple)):
            dims = None
        keep = args[2] if len(args) > 2 and isinstance(args[2], bool) \
            else kwargs.get("keepdim", False)
        return _norm_dims(dims, ndim), keep

    def _reduce(self, node, shape, args, kwargs, fl, fh):
        a = self.lift(args[0])
        ax, keep = self._red_args(node, args, kwargs, a.lo.ndim)
        lo = fl(a.lo, axis=ax, keepdims=True) if ax else a.lo
        hi = fh(a.hi, axis=ax, keepdims=True) if ax else a.hi
        return np.reshape(lo, shape), np.reshape(hi, shape)

    def _r_sum(self, node, shape, dtype, args, kwargs):
        def s(x, axis, keepdims):
            return _exact(lambda y: np.sum(y, axis=axis, keepdims=keepdims),
                          x)
        return self._reduce(node, shape, args, kwargs, s, s)

    def _r_any(self, node, shape, dtype, args, kwargs):
        lo, hi = self._reduce(node, shape, args, kwargs, np.max, np.max)
        return _bool_ival(lo > 0, hi > 0)

    def _r_all(self, node, shape, dtype, args, kwargs):
        lo, hi = self._reduce(node, shape, args, kwargs, np.min, np.min)
        return _bool_ival(lo > 0, hi > 0)

    def _r_amax(self, node, shape, dtype, args, kwargs):
        return self._reduce(node, shape, args, kwargs, np.max, np.max)

    def _r_amin(self, node, shape, dtype, args, kwargs):
        return self._reduce(node, shape, args, kwargs, np.min, np.min)

    def _minmax_dim(self, node, args, kwargs, f):
        metas = _out_meta(node)
        if len(args) > 1 and isinstance(args[1], Interval):
            # max.other / min.other: element-wise.
            (shape, _dt), = metas
            (al, ah), (bl, bh) = self._operands(args, kwargs, shape, 2)
            g = np.maximum if f is np.max else np.minimum
            return g(al, bl), g(ah, bh)
        if len(metas) == 1:         # max(x) / min(x): the whole tensor
            lo, hi = self._reduce(node, metas[0][0], [args[0]], {}, f, f)
            return _ival(lo, hi, metas[0][1])
        (vshape, vdt), (ishape, idt) = metas
        a = self.lift(args[0])
        dim = args[1] % a.lo.ndim
        lo, hi = self._reduce(node, vshape, args, kwargs, f, f)
        idx = _ival(np.zeros(ishape, _I64),
                    np.full(ishape, a.lo.shape[dim] - 1, _I64), idt)
        return _ival(lo, hi, vdt), idx

    def _r_max(self, node, shape, dtype, args, kwargs):
        return self._minmax_dim(node, args, kwargs, np.max)

    def _r_min(self, node, shape, dtype, args, kwargs):
        return self._minmax_dim(node, args, kwargs, np.min)


    def _r_cumprod(self, node, shape, dtype, args, kwargs):
        a = self.lift(args[0])
        d = args[1] % a.lo.ndim
        if bool(np.all(a.lo >= 0)):
            return (_exact(lambda y: np.cumprod(y, axis=d), a.lo),
                    _exact(lambda y: np.cumprod(y, axis=d), a.hi))
        return self.unknown(shape, dtype, "cumprod:negative")

    def _r_gather(self, node, shape, dtype, args, kwargs):
        x, dim, idx = self.lift(args[0]), args[1], self.lift(args[2])
        dim %= x.lo.ndim
        D = x.lo.shape[dim]
        ilo = np.clip(idx.lo, 0, D - 1)
        ihi = np.clip(idx.hi, 0, D - 1)
        sub = tuple(slice(0, s) if d != dim else slice(None)
                    for d, s in enumerate(idx.lo.shape))
        if bool(np.all(ilo == ihi)):
            return (np.take_along_axis(x.lo[sub], ilo, dim),
                    np.take_along_axis(x.hi[sub], ilo, dim))
        # Join over each element's index range: candidates along a last
        # axis of D, masked to the range.
        r = np.arange(D)
        inr = (r >= ilo[..., None]) & (r <= ihi[..., None])
        cand_lo = np.expand_dims(np.moveaxis(x.lo[sub], dim, -1), dim)
        cand_hi = np.expand_dims(np.moveaxis(x.hi[sub], dim, -1), dim)
        lo = np.where(inr, cand_lo, np.iinfo(_I64).max).min(-1)
        hi = np.where(inr, cand_hi, np.iinfo(_I64).min).max(-1)
        return lo, hi

    def _r_index_select(self, node, shape, dtype, args, kwargs):
        x = self.lift(args[0])
        return (np.full(shape, x.lo.min(), _I64),
                np.full(shape, x.hi.max(), _I64))

    _r_index = _r_index_select


# ---------------------------------------------------------------------------
# Taint domain


_EMPTY: FrozenSet[str] = frozenset()

#: Element-wise dependency footprint: field name -> bool mask over THAT
#: FIELD's (traced, batch-inclusive) shape.  Masks are treated as
#: immutable (never updated in place), so dictionaries may share arrays.
Deps = Dict[str, np.ndarray]


def _dunion(*dicts: Deps) -> Deps:
    """Key-wise OR of dependency footprints."""
    out: Deps = {}
    for d in dicts:
        for f, m in d.items():
            prev = out.get(f)
            out[f] = m if prev is None else (prev | m)
    return out


def read_mask(t: "Taint") -> Deps:
    """The value's full element-wise read set (value-level join of the
    positional and value-level halves)."""
    return _dunion(t.vdeps, t.pdeps)


@dataclasses.dataclass
class Taint(_Value):
    """Element-wise dependency/identity abstraction.

    - ``vdeps[f]`` — value-level: ANY element of this value may depend
      on the masked elements of field ``f``.
    - ``pdeps[f]`` — positional: element at flat position ``p`` of this
      value may depend on field ``f`` only through ``f``'s element at
      flat position ``p`` (the mask marks which).  Only held while the
      value has the field's size and an order-preserving layout of it
      (element-wise flows, views); every other op graduates it into
      ``vdeps`` (conservative).
    - ``origin``/``diff``: if ``origin`` is field F, elements where
      ``diff`` is False are *provably equal to input field F at the
      same position* — the write-set extractor reads successor fields'
      ``diff`` masks directly.
    - ``lo``/``hi``: the interval half; ``known`` where they agree (a
      value fixed by the instance's parameters), which keeps index masks
      like ``arange(N) == i`` exact so writes stay confined to the
      instance's own rows.
    """

    vdeps: Deps
    pdeps: Deps
    origin: Optional[str]
    diff: np.ndarray          # bool, value shape
    lo: np.ndarray            # int64, value shape
    hi: np.ndarray
    dtype: torch.dtype
    #: Every element known (cached; None = not yet computed).
    all_known: Optional[bool] = dataclasses.field(default=None, repr=False,
                                                  compare=False)

    def __post_init__(self):
        if self.all_known is None:
            self.all_known = bool(np.array_equal(self.lo, self.hi))

    @property
    def shape(self):
        return self.diff.shape

    @property
    def known(self) -> np.ndarray:
        return self.lo == self.hi

    @property
    def vals(self) -> np.ndarray:
        return self.lo

    @property
    def deps(self) -> FrozenSet[str]:
        """Field-level view of the read set."""
        return frozenset(set(self.vdeps) | set(self.pdeps))

    @property
    def interval(self) -> Interval:
        iv = self.__dict__.get("_iv")
        if iv is None:
            iv = self.__dict__["_iv"] = Interval(self.lo, self.hi,
                                                 self.dtype, self.all_known)
        return iv


def _taint(vdeps, pdeps, origin, diff, lo, hi, dtype) -> Taint:
    """A taint value; its arrays are never written after this (they may
    be shared)."""
    diff = np.asarray(diff, bool)
    lo, hi = _as_i64(lo), _as_i64(hi)
    if not (diff.shape == lo.shape == hi.shape):
        diff, lo, hi = (np.array(x)
                        for x in np.broadcast_arrays(diff, lo, hi))
    known = bool(np.array_equal(lo, hi))
    if known:
        vdeps, pdeps, origin = {}, {}, None
    vdeps = {f: m for f, m in vdeps.items() if m.any()}
    pdeps = {f: m for f, m in pdeps.items() if m.any()}
    return Taint(vdeps, pdeps, origin, diff, lo, hi, dtype, known)


def state_taint(field: str, shape, dtype=torch.int64) -> Taint:
    """A state input: depends positionally on every element of
    ``field`` (traced shape ``shape``), identical to it, value unknown
    across the dtype's whole range."""
    dlo, dhi = _dtype_range(dtype)
    return _taint({}, {field: np.ones(shape, bool)}, field,
                  np.zeros(shape, bool), np.full(shape, dlo, _I64),
                  np.full(shape, dhi, _I64), dtype)


def _opaque(vdeps, iv: Interval) -> Taint:
    """Depends (value-level) on ``vdeps``; value from ``iv``."""
    return _taint(vdeps, {}, None, np.ones(iv.shape, bool), iv.lo, iv.hi,
                  iv.dtype)


def _source_map(node, args, kwargs, src: Taint):
    """Flat source positions in ``src`` of every output element of a
    structural op (the op applied to ``arange(numel)``)."""
    ids = np.arange(int(np.prod(src.shape)), dtype=_I64).reshape(src.shape)
    out = _concrete_call(node, args, kwargs,
                         lambda v: ids if v is src else v.lo,
                         lambda v: torch.int64)
    return out.numpy()


class TaintDomain:
    """Transfer functions for dependency/identity extraction.  The only
    precision that matters downstream: (1) ``vdeps``/``pdeps`` never
    lose a real dependency, (2) ``diff`` is True wherever the element
    can differ from its origin field, (3) parameter-concrete index
    arithmetic stays ``known`` so per-instance write masks are
    lane-accurate, (4) the positional half is claimed only through
    order-preserving flows, so intersecting it with a write's ``diff``
    mask yields a sound slot-precise read set."""

    def __init__(self):
        self.notes: List[str] = []
        # The value half: wraps widen to the full range (a clipped bound
        # would claim a value the wrapped element does not have).
        self._iv = IntervalDomain(widen_wraps=True)

    def lift(self, x):
        if isinstance(x, Taint):
            return x
        iv = self._iv.lift(x)
        return _taint({}, {}, None, np.ones(iv.shape, bool), iv.lo, iv.hi,
                      iv.dtype)

    def unknown(self, ivs, invals, why: str):
        if why not in self.notes:
            self.notes.append(why)
        vdeps = _dunion(*(read_mask(v) for v in invals)) if invals else {}
        if isinstance(ivs, tuple):
            return tuple(_opaque(vdeps, iv) for iv in ivs)
        return _opaque(vdeps, ivs)

    def apply(self, node, args, kwargs):
        name = _packet(node)
        tvals = _leaves(args, Taint) + _leaves(kwargs, Taint)
        iv_args = _tree_map(lambda v: v.interval if isinstance(v, Taint)
                            else v, args)
        iv_kw = {k: _tree_map(lambda v: v.interval if isinstance(v, Taint)
                              else v, w) for k, w in kwargs.items()}
        ivs = self._iv.apply(node, iv_args, iv_kw)
        if name in _LIKE or all(v.all_known for v in tvals):
            return _tree_map(lambda iv: _opaque({}, iv), ivs) \
                if isinstance(ivs, tuple) else _opaque({}, ivs)
        if name == "where":
            return self._where(node, args, ivs)
        if name in _ELEMENTWISE or (name in ("max", "min")
                                    and len(_leaves(args, Taint)) > 1):
            vdeps, pdeps = self._join_deps(ivs.shape, tvals)
            return _taint(vdeps, pdeps, None, np.ones(ivs.shape, bool),
                          ivs.lo, ivs.hi, ivs.dtype)
        if name in _IDENTITY:
            a = tvals[0]
            return _taint(a.vdeps, a.pdeps, a.origin,
                          a.diff.reshape(ivs.shape), ivs.lo, ivs.hi,
                          ivs.dtype)
        if name in _STRUCTURAL:
            return self._structural(node, args, kwargs, tvals, ivs)
        if name in ("gather", "index_select", "index"):
            return self._indexed(node, name, args, kwargs, ivs)
        if name in _REDUCTIONS:
            vdeps = _dunion(*(read_mask(v) for v in tvals))
            if isinstance(ivs, tuple):
                return tuple(_opaque(vdeps, iv) for iv in ivs)
            return _opaque(vdeps, ivs)
        return self.unknown(ivs, tvals, f"op:{name}")

    def _join_deps(self, shape, invals) -> Tuple[Deps, Deps]:
        """(vdeps, pdeps) of an element-wise combination: an input of
        the output's shape keeps its positional half; a broadcast input
        graduates it to value-level (element p of the output no longer
        maps to element p of the field)."""
        vd: List[Deps] = []
        pd: List[Deps] = []
        for v in invals:
            if v.shape == tuple(shape):
                vd.append(v.vdeps)
                pd.append(v.pdeps)
            else:
                vd.append(read_mask(v))
        return _dunion(*vd), _dunion(*pd)

    # -- selection -----------------------------------------------------
    def _where(self, node, args, ivs):
        shape = ivs.shape
        pred, a, b = (self.lift(x) for x in args[:3])
        pk = np.broadcast_to(pred.known, shape)
        pv = np.broadcast_to(pred.vals, shape) != 0
        all_known = bool(pk.all())
        used = [bool(np.any(pk & pv)) or not all_known,
                bool(np.any(pk & ~pv)) or not all_known]
        cases = (a, b)
        vdeps, pdeps = self._join_deps(
            shape, [pred] + [c for k, c in enumerate(cases) if used[k]])
        # origin/diff: identity is kept only when exactly one input field
        # appears as a case origin.
        origins = {c.origin for c in cases
                   if c.origin is not None and c.shape == shape}
        if len(origins) == 1:
            origin = next(iter(origins))
            da, db = (c.diff if c.origin == origin and c.shape == shape
                      else np.ones(shape, bool) for c in cases)
            diff = np.where(pk, np.where(pv, da, db), da | db)
        else:
            origin, diff = None, np.ones(shape, bool)
        return _taint(vdeps, pdeps, origin, diff, ivs.lo, ivs.hi,
                      ivs.dtype)

    # -- structure -----------------------------------------------------
    def _structural(self, node, args, kwargs, tvals, ivs):
        """Element moves: a single-input op that keeps every element at
        its flat position keeps the positional half and the identity;
        otherwise the positional half restricted to the elements that
        flow through becomes value-level."""
        if len(tvals) == 1:
            a = tvals[0]
            srcs = _source_map(node, args, kwargs, a)
            n = int(np.prod(a.shape))
            if srcs.size == n and np.array_equal(srcs.reshape(-1),
                                                 np.arange(n)):
                return _taint(a.vdeps, a.pdeps, a.origin,
                              a.diff.reshape(ivs.shape), ivs.lo, ivs.hi,
                              ivs.dtype)
            region = np.zeros(n, bool)
            region[srcs.reshape(-1)] = True
            vdeps = self._read_through(a, region.reshape(a.shape))
            return _taint(vdeps, {}, None, np.ones(ivs.shape, bool),
                          ivs.lo, ivs.hi, ivs.dtype)
        vdeps = _dunion(*(read_mask(v) for v in tvals))
        return _taint(vdeps, {}, None, np.ones(ivs.shape, bool), ivs.lo,
                      ivs.hi, ivs.dtype)

    @staticmethod
    def _read_through(operand: Taint, region: np.ndarray) -> Deps:
        """Element-wise read set of an access touching ``region`` (a mask
        over ``operand``'s shape): the positional half is restricted to
        the touched positions, the value-level half cannot be."""
        return _dunion(operand.vdeps,
                       {f: m & region.reshape(m.shape)
                        for f, m in operand.pdeps.items()})

    # -- indexed access (element-precise where the indices are) --------
    #
    # An access whose index is parameter-concrete touches exactly the
    # indexed elements; a state-dependent index touches the range its
    # interval admits along its own axis, so ``log_term.view(X, N*L)``
    # gathered at ``i * L + clamp(k, 0, L - 1)`` with a concrete ``i``
    # reads row ``i`` only, while ``term`` gathered at a message's
    # ``mdest`` reads the whole field (genuine, not an artifact).

    def _indexed(self, node, name, args, kwargs, ivs):
        x = self.lift(args[0])
        idx_vals = _leaves(args[1:], Taint) + _leaves(kwargs, Taint)
        if all(bool(i.known.all()) for i in idx_vals):
            srcs = _source_map(node, args, kwargs, x)
            region = np.zeros(int(np.prod(x.shape)), bool)
            region[srcs.reshape(-1)] = True
            region = region.reshape(x.shape)
        elif name == "gather":
            dim = args[1] % len(x.shape)
            idx = self.lift(args[2])
            D = x.shape[dim]
            ilo, ihi = np.clip(idx.lo, 0, D - 1), np.clip(idx.hi, 0, D - 1)
            region = np.zeros(x.shape, bool)
            ext = tuple(slice(0, s) for s in idx.shape)
            for r in range(D):
                inr = ((ilo <= r) & (r <= ihi)).any(axis=dim, keepdims=True)
                sl = list(ext)
                sl[dim] = slice(r, r + 1)
                region[tuple(sl)] |= inr
        else:
            region = np.ones(x.shape, bool)
        vdeps = _dunion(self._read_through(x, region),
                        *(read_mask(i) for i in idx_vals))
        return _taint(vdeps, {}, None, np.ones(ivs.shape, bool), ivs.lo,
                      ivs.hi, ivs.dtype)


# ---------------------------------------------------------------------------
# Tracing


#: Held while ``make_fx`` traces (torch.fx's tracer patches
#: ``torch.nn.Module.__call__`` and ``__getattr__`` process-wide for the
#: length of a trace) and while ``lint.kernels_as_launches`` swaps the
#: kernel wrappers: concurrent traces, a served job's in-process POR
#: certification among them, take turns.
TRACE_LOCK = threading.RLock()


def make_graph(fn, inputs):
    """``fn`` traced by ``make_fx`` in real mode on ``inputs``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with TRACE_LOCK, torch.no_grad():
        return make_fx(fn, tracing_mode="real")(*inputs)


def state_inputs(dims) -> List[torch.Tensor]:
    """Zero CPU tensors of one parent row per ``StateBatch`` field (the
    trace's example inputs; real-mode tracing records ops, not values)."""
    from . import lane_map
    shapes = lane_map.field_shapes(dims)
    return [torch.zeros((1,) + shapes[f], dtype=torch.int64)
            for f in lane_map.FIELDS]


def trace_family(kernel, dims, n_params: int):
    """Trace one action-family kernel to an aten ``GraphModule`` whose
    placeholders are the 13 ``StateBatch`` fields (lane_map.FIELDS
    order, one parent row each) followed by the ``[1, 1]`` parameters;
    its outputs are ``(enabled, overflow, *successor fields)``.  Traced
    once per family: per-instance analysis re-evaluates the same graph
    with that instance's concrete parameters, as ``build_expand`` runs
    the same kernel over the family's parameter tables."""
    from ..models.schema import StateBatch
    from . import lane_map
    nf = len(lane_map.FIELDS)

    def flat(*args):
        en, ovf, succ = kernel(StateBatch(*args[:nf]), *args[nf:])
        return (en, ovf) + tuple(succ)

    # Distinct tensors: the tracer keys placeholders by tensor identity.
    params = [torch.zeros((1, 1), dtype=torch.int64)
              for _ in range(n_params)]
    return make_graph(flat, state_inputs(dims) + params)


def trace_predicate(kernel, dims):
    """Trace one state predicate ``kernel(StateBatch) -> [X] bool`` to a
    ``GraphModule`` over the 13 state fields — the invariant-side twin
    of :func:`trace_family`."""
    from ..models.schema import StateBatch

    def flat(*fields):
        return kernel(StateBatch(*fields))

    return make_graph(flat, state_inputs(dims))


@functools.lru_cache(maxsize=8)
def traced_kernels(dims):
    """``build_kernels(dims)`` with each family traced: ``((name, graph,
    params), ...)`` in ``dims.family_names`` order, ``params`` the
    family's parameter tables as numpy arrays.  Memoized on ``dims``
    (frozen) because every pass re-derives the same graphs; tests drop
    it with ``traced_kernels.cache_clear()``."""
    from ..models.actions import build_kernels
    out = []
    for name, kern, params in build_kernels(dims, "cpu"):
        arrays = tuple(np.asarray(p.cpu().numpy(), _I64) for p in params)
        out.append((name, trace_family(kern, dims, len(params)), arrays))
    return tuple(out)


def param_args(row) -> List[np.ndarray]:
    """One instance's parameter values as the graph's ``[1, 1]`` inputs."""
    return [np.full((1, 1), int(v), _I64) for v in row]
