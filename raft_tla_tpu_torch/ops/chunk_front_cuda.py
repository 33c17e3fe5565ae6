"""The v4 chunk front: the CUDA kernel ``csrc/chunk_front.cu`` and its wrapper.

Replaces the JAX package's ``ops/chunk_front_pallas.py`` (``_front_kernel``,
built by ``build_front``).  A ``Front``, built once per engine, called on
``(rows, valid)`` gives the 14 outputs of ``ops/chunk_front.py``
(``FrontOut``).  For CPU tensors it runs
``front_plain``; for CUDA tensors it launches the kernel (four launches
on the current stream: masks, the multi-block compaction, the lanes'
keys and the lanes' build over every live lane; counted as one front
call) or raises.

The v4 step runs the two halves apart, with the seen-set insert between
them: ``Front.keys(rows, valid)`` gives every output but the successors
(``krows``, ``cons_ok`` and ``inv`` allocated and unwritten) and the
lanes' edit records; ``Front.build(rows, out, edits, mask, ...)`` then
writes the three on the live lanes of ``mask`` (the insert's ``is_new``)
and nowhere else.  Both halves are launches of the one ``lanes_kernel``
template.  On CPU tensors they run ``keys_plain`` and ``build_plain``.

What the kernel takes is fixed when the front is built, and anything else
raises ``ValueError`` there, on either device, so a v4 engine never finds
out mid-run that its kernel cannot run it:

- dims up to ``n_servers`` 8, ``max_log`` 16, ``n_msg_slots`` 256 whose
  masks and lanes launches fit a block's shared memory (``check_dims``),
  of the spec or of the reconfiguration variant (``ReconfigDims``, up to
  32 targets; its own builds of the masks and lanes launches), and of no
  other variant;
- invariants by registry name (``PREDICATES``: TypeOK, NoLeaderElected
  and the nine of the safety suite; at most 16), each built by
  ``models/invariants.py`` or ``models/safety.py`` (which tag it with
  ``.predicate``); a list that names one of the suite's runs the build
  launch's build with the suite's device code, the spec's or the
  variant's (``reconfig_suite``), which reads the variant's values whole;
- the ``BoundedSpace`` constraint or none.

The fingerprint salt tables (``ops/fingerprint.py`` ``constants_np``) and
the POR arrays are uploaded once, when the front is built.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.invariants import build_inv_id
from ..models.reconfig import ReconfigDims
from ..models.schema import state_width
from ..utils import build
from .chunk_front import FrontOut, build_plain, front_plain, keys_plain
from .compact import kspread as make_kspread
from .fingerprint import constants_np

#: Front calls that launched the kernel since the last reset.
launches = 0

#: The CUDA launches of one front call, in order: the lanes' keys and
#: build are both ``lanes_kernel`` in a trace.
LAUNCHES = ("masks_kernel", "compact_scan_kernel", "lanes_kernel.keys",
            "lanes_kernel.build")

#: Invariants with device code, by registry name -> the kernel's code
#: (``csrc/raft_model.cuh`` ``PRED_*``).
PREDICATES = {"TypeOK": 1, "NoLeaderElected": 2, "MessagesInv": 3,
              "LeaderVotesQuorum": 4, "CandidateTermNotInLog": 5,
              "ElectionSafety": 6, "LogMatching": 7, "VotesGrantedInv": 8,
              "QuorumLogInv": 9, "MoreUpToDateCorrect": 10,
              "LeaderCompleteness": 11}
MAX_SERVERS, MAX_LOG, MAX_SLOTS, MAX_INVARIANTS = 8, 16, 256, 16
MAX_TARGETS = 32
MAX_SMEM = 232448
INT_MAX = 2**31 - 1


def predicate_codes(inv_fns):
    """Kernel codes of ``inv_fns`` in order; ``ValueError`` for a predicate
    the kernel has no device code for, or a list longer than it takes."""
    fns = list(inv_fns or [])
    if len(fns) > MAX_INVARIANTS:
        raise ValueError(f"chunk front: {len(fns)} invariants, the kernel "
                         f"takes at most {MAX_INVARIANTS}")
    codes = []
    for fn in fns:
        name = getattr(fn, "predicate", None)
        if name not in PREDICATES:
            raise ValueError(
                f"chunk front: no device code for invariant "
                f"{name or fn!r}; the kernel has {sorted(PREDICATES)}")
        codes.append(PREDICATES[name])
    return codes


def constraint_bounds(constraint):
    """``(max_term, max_log_len, max_msg_count, max_in_flight)`` with
    INT_MAX for an unset bound (and for no constraint)."""
    if constraint is None:
        return (INT_MAX,) * 4
    if getattr(constraint, "predicate", None) != "BoundedSpace":
        raise ValueError(f"chunk front: no device code for constraint "
                         f"{constraint!r}; the kernel has BoundedSpace")
    b = constraint.bounds
    vals = (b.max_term, b.max_log_len, b.max_msg_count, b.max_in_flight)
    return tuple(INT_MAX if v is None else min(int(v), INT_MAX)
                 for v in vals)


def _align16(n):
    return (n + 15) & ~15


def masks_smem(dims):
    """Shared bytes of the masks launch: 8 warps, each a decoded row of
    ints and two [G] byte masks."""
    return 8 * (_align16(4 * state_width(dims))
                + _align16(2 * dims.n_instances))


def keys_smem(dims):
    """Shared bytes of the keys launch (``csrc/chunk_front.cu``
    ``keys_smem``): 8 decoded parents (rows of ints), a 64-lane run's
    edit lists (``13 + 2 N`` edits of an int value and a 16-bit position
    each) and message rows (W ints), 9 int arrays of 64, 32 ints of block
    scan and 16 family counts."""
    sw = state_width(dims)
    edits = 64 * (13 + 2 * dims.n_servers)
    return (8 * _align16(4 * sw) + _align16(4 * edits) + _align16(2 * edits)
            + _align16(4 * 64 * dims.msg_width) + 4 * (9 * 64 + 32 + 16))


def build_smem(dims):
    """Shared bytes of the build launch (``csrc/chunk_front.cu``
    ``build_smem``): up to 8 decoded parents (as many as keep the block
    within 55 KB, at least one) and 8 warps' decoded successors (rows of
    ints), 8 warps' byte rows, 3 int arrays of 64, 32 ints of block scan
    and a count a warp."""
    sw = state_width(dims)
    rest = 8 * (_align16(4 * sw) + _align16(sw + 16)) + 4 * (3 * 64 + 32 + 8)
    cap = min(8, max(1, (55 * 1024 - rest) // _align16(4 * sw)))
    return cap * _align16(4 * sw) + rest


def check_dims(dims):
    """``ValueError`` unless the kernel takes ``dims``: the spec or the
    reconfiguration variant (at most ``MAX_TARGETS`` targets), the static
    maxima, and the masks, keys and build launches' shared memory within
    the H100's 227 KB a block."""
    if dims.extra_families and not isinstance(dims, ReconfigDims):
        raise ValueError(f"chunk front: no device code for the variant "
                         f"{type(dims).__name__}")
    if isinstance(dims, ReconfigDims) and len(dims.targets) > MAX_TARGETS:
        raise ValueError(f"chunk front: {len(dims.targets)} target configs, "
                         f"the kernel takes at most {MAX_TARGETS}")
    smem = max(masks_smem(dims), keys_smem(dims), build_smem(dims))
    if (dims.n_servers > MAX_SERVERS or dims.max_log > MAX_LOG
            or dims.n_msg_slots > MAX_SLOTS or smem > MAX_SMEM):
        raise ValueError(
            f"chunk front: dims (n_servers={dims.n_servers}, max_log="
            f"{dims.max_log}, n_msg_slots={dims.n_msg_slots}) exceed the "
            f"kernel's ({MAX_SERVERS}, {MAX_LOG}, {MAX_SLOTS}, "
            f"{MAX_SMEM} bytes of shared memory; these need {smem})")


def salts(dims, device) -> torch.Tensor:
    """``[seed0, seed1, c_ord0, c_ord1, c_msg0, c_msg1]`` as uint32 bits in
    an int32 tensor (the kernel's layout)."""
    c = constants_np(dims)
    flat = np.concatenate([
        np.array([c[0][2], c[1][2]], np.uint32), c[0][0], c[1][0],
        c[0][1], c[1][1]]).astype(np.uint32)
    return torch.as_tensor(flat.view(np.int32), device=device)


def edit_record_bytes(dims):
    """Bytes of one lane's edit record (``csrc/chunk_front.cu``
    ``EditRecs``): its meta word, ``13 + 2 N`` edits of an int value and
    a 16-bit position, and a message row of W ints."""
    return 4 + 6 * (13 + 2 * dims.n_servers) + 4 * dims.msg_width


def bind(lib):
    """``lib`` (a build of ``csrc/chunk_front.cu``) with the argument
    types of its two launch entries set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
            (lib.chunk_front_launch,
             [i] * 4 + [ctypes.POINTER(i), i] + [p, p, i, i] + [p] * 18),
            (lib.chunk_front_build,
             [i] * 4 + [ctypes.POINTER(i), i] + [p, i, p, p]
             + [ctypes.POINTER(i), i] + [i] * 4 + [p] * 9)):
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _lib():
    lib = build.library("chunk_front")
    if lib.chunk_front_launch.argtypes is None:
        bind(lib)
    return lib


class Front:
    """The front of one engine (dims, predicates, B, K, POR arrays)."""

    def __init__(self, *, dims, v2, inv_fns, constraint, B: int, K: int,
                 device, por_mask=None, por_priority=None):
        check_dims(dims)
        #: Whether the masks, keys and build launches run the
        #: reconfiguration variant's builds.
        self.reconfig = isinstance(dims, ReconfigDims)
        self._codes = predicate_codes(inv_fns)
        self._bounds = constraint_bounds(constraint)
        if (por_mask is None) != (por_priority is None):
            raise ValueError("por_mask and por_priority must be given "
                             "together")
        G = dims.n_instances
        if K & (K - 1) or K < G:
            raise ValueError(f"chunk front: K={K} must be a power of two "
                             f">= G={G}")
        dev = torch.device(device)
        self.dims, self.B, self.K, self.G = dims, B, K, G
        self.sw = state_width(dims)
        self._v2, self._constraint = v2, constraint
        self._inv_id = build_inv_id(list(inv_fns)) if inv_fns else None
        self._kspread = make_kspread(B, G, K, dev)
        self._por = None
        if por_mask is not None:
            pm = torch.as_tensor(por_mask, device=dev)   # arrays or tensors
            pp = torch.as_tensor(por_priority, device=dev)
            if pm.shape != (G,) or pp.shape != (G,) \
                    or pm.dtype != torch.bool or pp.dtype != torch.int32:
                raise ValueError(f"POR mask/priority must be bool/int32 "
                                 f"[{G}]")
            self._por = (pm, pp)
        self._salts = salts(dims, dev) if dev.type == "cuda" else None
        # A host array: the launcher packs it into the build launch's
        # arguments (and refuses a code it has no device code for).
        self._inv_codes = (ctypes.c_int * max(1, len(self._codes)))(
            *self._codes)
        targets = dims.targets if self.reconfig else ()
        self._targets = (ctypes.c_int * max(1, len(targets)))(*targets)
        self._n_targets = len(targets)
        #: Whether the build launch runs its build with the safety suite.
        self.suite = any(c > PREDICATES["NoLeaderElected"]
                         for c in self._codes)

    def plain(self, rows, valid) -> FrontOut:
        pm, pp = self._por or (None, None)
        return front_plain(rows, valid, dims=self.dims, v2=self._v2,
                           K=self.K, kspread=self._kspread,
                           constraint=self._constraint, inv_id=self._inv_id,
                           por_mask=pm, por_priority=pp)

    def keys_plain(self, rows, valid) -> FrontOut:
        pm, pp = self._por or (None, None)
        return keys_plain(rows, valid, dims=self.dims, v2=self._v2, K=self.K,
                          kspread=self._kspread, por_mask=pm,
                          por_priority=pp)

    def build_plain(self, rows, out: FrontOut, mask, built=None):
        return build_plain(rows, out, mask, dims=self.dims, v2=self._v2,
                           constraint=self._constraint, inv_id=self._inv_id,
                           built=built)

    @property
    def build_name(self) -> str:
        """The build launch's build: ``typeok`` (TypeOK and
        NoLeaderElected), ``suite`` (with the safety suite's device code),
        ``reconfig`` and ``reconfig_suite`` (the variant's two)."""
        if self.reconfig:
            return "reconfig_suite" if self.suite else "reconfig"
        return "suite" if self.suite else "typeok"

    def _builds(self):
        """The codes (``csrc/chunk_front.cu`` ``with_build``) of the
        builds one call of this front launches, in ``LAUNCHES`` order."""
        if self.reconfig:
            return (5, 1, 6, 8 if self.suite else 7)
        return (0, 1, 2, 4 if self.suite else 3)

    def launch_info(self):
        """``{launch: build.kernel_info}`` of each launch of one call, of
        the builds this front runs (``LAUNCHES``)."""
        d = self.dims
        return {name: build.kernel_info(
                    "chunk_front", w, d.n_servers, d.n_values, d.max_log,
                    d.n_msg_slots, self._n_targets, self.B, self.K)
                for w, name in zip(self._builds(), LAUNCHES)}

    def occupancy(self):
        """``{launch: n}``: blocks of the masks, keys and build launches
        that one SM holds at this front's dims (the CUDA occupancy
        calculator), of the builds this front runs."""
        d = self.dims
        fn = _lib().chunk_front_occupancy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        got = {}
        for w, name in zip(self._builds(), LAUNCHES):
            if name == "compact_scan_kernel":
                continue
            out = (ctypes.c_int * 1)()
            build.check(fn(w, d.n_servers, d.n_values, d.max_log,
                           d.n_msg_slots, self._n_targets, out),
                        "chunk_front_occupancy")
            got[name] = out[0]
        return got

    def record(self) -> dict:
        """What this front runs: ``build``, the build launch's build
        (``build_name``), ``predicates``, the codes in the run's order, and
        on the card ``launches``: each launch's registers, local bytes a
        thread (spills), shared bytes (static and dynamic) and, but for
        the compaction, blocks an SM."""
        out = {"build": self.build_name, "predicates": list(self._codes),
               "launches": {}}
        if self._kspread.device.type != "cuda":
            return out
        occupancy = self.occupancy()
        for name, info in self.launch_info().items():
            launch = {"registers": info["registers"],
                      "spill_bytes": info["local_bytes"],
                      "shared_bytes": (info["static_smem"]
                                       + info["dynamic_smem"])}
            if name in occupancy:
                launch["blocks_per_sm"] = occupancy[name]
            out["launches"][name] = launch
        return out

    def _check_rows(self, rows, valid):
        if rows.device.type != "cuda":
            raise ValueError(f"chunk front: unsupported device {rows.device}")
        if (rows.dtype != torch.uint8 or rows.shape != (self.B, self.sw)
                or not rows.is_contiguous() or valid.dtype != torch.bool
                or valid.shape != (self.B,) or rows.device != valid.device
                or rows.device != self._kspread.device):
            raise ValueError(f"chunk front: rows must be contiguous uint8 "
                             f"[{self.B}, {self.sw}] and valid bool "
                             f"[{self.B}] on the front's device")

    def keys(self, rows, valid):
        """``(out, edits)``: the keys half of one front call.  ``out`` is a
        ``FrontOut`` whose ``krows``, ``cons_ok`` and ``inv`` are left for
        ``build``; ``edits`` the lanes' edit records it reads (None on the
        CPU, whose build recomputes the successors from the parents).  On
        the card: the masks, compaction and keys launches."""
        global launches
        if rows.device.type == "cpu":
            return self.keys_plain(rows, valid), None
        self._check_rows(rows, valid)
        valid = valid.contiguous()
        B, G, K, sw = self.B, self.G, self.K, self.sw
        dev = rows.device
        d = self.dims

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        scratch = empty((B, 6 + 2 * d.n_msg_slots), torch.int32)
        counts = empty(B, torch.int32)
        pt = empty(2, torch.int32)
        edits = empty(K * edit_record_bytes(d), torch.uint8)
        out = FrontOut(
            en=empty((B, G), torch.bool), ovf=empty((B, G), torch.bool),
            pruned=empty((B, G), torch.bool), P=pt[0], total=pt[1],
            lane_id=empty(K, torch.int32), kvalid=empty(K, torch.bool),
            kh=empty(K, torch.int64), kl=empty(K, torch.int64),
            krows=empty((K, sw), torch.uint8),
            cons_ok=empty(K, torch.bool), inv=empty(K, torch.int64),
            parent_hi=empty(K, torch.int64), parent_lo=empty(K, torch.int64))
        pm, pp = self._por or (None, None)
        err = _lib().chunk_front_launch(
            d.n_servers, d.n_values, d.max_log, d.n_msg_slots,
            self._targets, self._n_targets, rows.data_ptr(),
            valid.data_ptr(), B, K, self._kspread.data_ptr(),
            pm.data_ptr() if pm is not None else None,
            pp.data_ptr() if pp is not None else None,
            self._salts.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
            out.en.data_ptr(), out.ovf.data_ptr(), out.pruned.data_ptr(),
            pt.data_ptr(), out.lane_id.data_ptr(), out.kvalid.data_ptr(),
            out.kh.data_ptr(), out.kl.data_ptr(), out.parent_hi.data_ptr(),
            out.parent_lo.data_ptr(), edits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "chunk_front_launch")
        launches += 1
        return out, edits

    def build(self, rows, out: FrontOut, edits, mask, tile_count=None,
              built=None):
        """The build half on the live lanes of ``mask`` ([K] bool, on the
        card a flag array the launch before may still write): their
        successor rows, constraint and invariant id into ``out.krows``,
        ``out.cons_ok`` and ``out.inv``, and no other lane written.  On
        the card ``tile_count`` (int32, a 64-lane tile each), where
        given, gets each tile's count of built lanes whose constraint
        holds; ``built`` ([1] or [2] int32), where given, counts in its
        first word the lanes built, and in a second word, where it has
        one, those of them in which some server's latest config entry is
        joint (none for the spec), on either device.  Returns
        ``out.cons_ok``."""
        if rows.device.type == "cpu":
            return self.build_plain(rows, out, mask, built)
        d, K = self.dims, self.K
        if (mask.dtype != torch.bool or mask.shape != (K,)
                or not mask.is_contiguous() or mask.device != rows.device):
            raise ValueError(f"chunk front: the build's mask must be "
                             f"contiguous bool [{K}] on the rows' device")
        tiles = -(-K // 64)
        if tile_count is not None and (tile_count.dtype != torch.int32
                                       or tile_count.numel() < tiles):
            raise ValueError(f"chunk front: tile counts must be int32 of "
                             f"at least {tiles}")
        if built is not None and (built.dtype != torch.int32
                                  or built.numel() not in (1, 2)
                                  or not built.is_contiguous()):
            raise ValueError("chunk front: the built counter must be one "
                             "or two contiguous int32 words")
        joint = (built.data_ptr() + 4
                 if built is not None and built.numel() == 2 else None)
        err = _lib().chunk_front_build(
            d.n_servers, d.n_values, d.max_log, d.n_msg_slots,
            self._targets, self._n_targets, rows.data_ptr(), K,
            out.total.data_ptr(), out.lane_id.data_ptr(), self._inv_codes,
            len(self._codes), *self._bounds, edits.data_ptr(),
            mask.data_ptr(),
            tile_count.data_ptr() if tile_count is not None else None,
            built.data_ptr() if built is not None else None, joint,
            out.krows.data_ptr(), out.cons_ok.data_ptr(), out.inv.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
        build.check(err, "chunk_front_build")
        return out.cons_ok

    def __call__(self, rows, valid) -> FrontOut:
        """One front call: every live lane's outputs (the keys, then the
        build over every live lane)."""
        if rows.device.type == "cpu":
            return self.plain(rows, valid)
        out, edits = self.keys(rows, valid)
        self.build(rows, out, edits, out.kvalid)
        return out
