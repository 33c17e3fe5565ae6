"""The v4 chunk front: the CUDA kernel ``csrc/chunk_front.cu`` and its wrapper.

Replaces the JAX package's ``ops/chunk_front_pallas.py`` (``_front_kernel``,
built by ``build_front``).  A ``Front``, built once per engine, called on
``(rows, valid)`` gives the 14 outputs of ``ops/chunk_front.py``
(``FrontOut``).  For CPU tensors it runs
``front_plain``; for CUDA tensors it launches the kernel (three launches
on the current stream: masks, the multi-block compaction, lanes; counted
as one front call) or raises.

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
  ``.predicate``); a list that names one of the suite's runs the lanes
  launch's build with the suite's device code (not for the variant);
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
from .chunk_front import FrontOut, front_plain
from .compact import kspread as make_kspread
from .fingerprint import constants_np

#: Front calls that launched the kernel since the last reset.
launches = 0

#: The CUDA launches of one front call, in order.
KERNELS = ("masks_kernel", "compact_scan_kernel", "lanes_kernel")

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


def predicate_codes(inv_fns, reconfig=False):
    """Kernel codes of ``inv_fns`` in order; ``ValueError`` for a predicate
    the kernel has no device code for (the safety suite's, for the
    reconfiguration variant)."""
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
        if reconfig and PREDICATES[name] > PREDICATES["NoLeaderElected"]:
            raise ValueError(
                f"chunk front: no device code for invariant {name} with "
                "the reconfiguration variant; its builds take TypeOK and "
                "NoLeaderElected (use the v3 plan)")
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


def lanes_smem(dims):
    """Shared bytes of the lanes launch (``csrc/chunk_front.cu``
    ``lanes_smem``): 8 decoded parents and 8 warps' decoded successors
    (rows of ints), 8 warps' byte rows, a 64-lane run's edit lists
    (``13 + 2 N`` edits of an int value and a 16-bit position each) and
    message rows (W ints), 9 int arrays of 64, 32 ints of block scan and
    16 family counts."""
    sw = state_width(dims)
    edits = 64 * (13 + 2 * dims.n_servers)
    return (16 * _align16(4 * sw) + 8 * _align16(sw + 16)
            + _align16(4 * edits) + _align16(2 * edits)
            + _align16(4 * 64 * dims.msg_width) + 4 * (9 * 64 + 32 + 16))


def check_dims(dims):
    """``ValueError`` unless the kernel takes ``dims``: the spec or the
    reconfiguration variant (at most ``MAX_TARGETS`` targets), the static
    maxima, and the masks and lanes launches' shared memory within the
    H100's 227 KB a block."""
    if dims.extra_families and not isinstance(dims, ReconfigDims):
        raise ValueError(f"chunk front: no device code for the variant "
                         f"{type(dims).__name__}")
    if isinstance(dims, ReconfigDims) and len(dims.targets) > MAX_TARGETS:
        raise ValueError(f"chunk front: {len(dims.targets)} target configs, "
                         f"the kernel takes at most {MAX_TARGETS}")
    smem = max(masks_smem(dims), lanes_smem(dims))
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


def _lib():
    lib = build.library("chunk_front")
    fn = lib.chunk_front_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] * 4 + [ctypes.POINTER(i), i] + [p, p, i, i]
                       + [p] * 4
                       + [ctypes.POINTER(i), i] + [i] * 4 + [p, p]
                       + [p] * 13 + [p])
    return lib


class Front:
    """The front of one engine (dims, predicates, B, K, POR arrays)."""

    def __init__(self, *, dims, v2, inv_fns, constraint, B: int, K: int,
                 device, por_mask=None, por_priority=None):
        check_dims(dims)
        #: Whether the masks and lanes launches run the reconfiguration
        #: variant's builds.
        self.reconfig = isinstance(dims, ReconfigDims)
        self._codes = predicate_codes(inv_fns, self.reconfig)
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
        # A host array: the launcher packs it into the lanes launch's
        # arguments (and refuses a code it has no device code for).
        self._inv_codes = (ctypes.c_int * max(1, len(self._codes)))(
            *self._codes)
        targets = dims.targets if self.reconfig else ()
        self._targets = (ctypes.c_int * max(1, len(targets)))(*targets)
        self._n_targets = len(targets)
        #: Whether the lanes launch runs its build with the safety suite.
        self.suite = any(c > PREDICATES["NoLeaderElected"]
                         for c in self._codes)

    def plain(self, rows, valid) -> FrontOut:
        pm, pp = self._por or (None, None)
        return front_plain(rows, valid, dims=self.dims, v2=self._v2,
                           K=self.K, kspread=self._kspread,
                           constraint=self._constraint, inv_id=self._inv_id,
                           por_mask=pm, por_priority=pp)

    def _builds(self):
        """The codes (``csrc/chunk_front.cu`` ``with_build``) of the
        builds one call of this front launches, in ``KERNELS`` order."""
        if self.reconfig:
            return (4, 1, 5)
        return (0, 1, 3 if self.suite else 2)

    def launch_info(self):
        """``{kernel: build.kernel_info}`` of each launch of one call, of
        the builds this front runs."""
        d = self.dims
        return {name: build.kernel_info(
                    "chunk_front", w, d.n_servers, d.n_values, d.max_log,
                    d.n_msg_slots, self._n_targets, self.B, self.K)
                for w, name in zip(self._builds(), KERNELS)}

    def occupancy(self):
        """``{"masks_kernel": n, "lanes_kernel": n}``: blocks of each
        launch that one SM holds at this front's dims (the CUDA occupancy
        calculator), of the builds this front runs."""
        d = self.dims
        fn = _lib().chunk_front_occupancy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        got = {}
        for w, name in zip(self._builds(), KERNELS):
            if name == "compact_scan_kernel":
                continue
            out = (ctypes.c_int * 1)()
            build.check(fn(w, d.n_servers, d.n_values, d.max_log,
                           d.n_msg_slots, self._n_targets, out),
                        "chunk_front_occupancy")
            got[name] = out[0]
        return got

    def __call__(self, rows, valid) -> FrontOut:
        global launches
        if rows.device.type == "cpu":
            return self.plain(rows, valid)
        if rows.device.type != "cuda":
            raise ValueError(f"chunk front: unsupported device {rows.device}")
        B, G, K, sw = self.B, self.G, self.K, self.sw
        if (rows.dtype != torch.uint8 or rows.shape != (B, sw)
                or not rows.is_contiguous() or valid.dtype != torch.bool
                or valid.shape != (B,) or rows.device != valid.device
                or rows.device != self._kspread.device):
            raise ValueError(f"chunk front: rows must be contiguous uint8 "
                             f"[{B}, {sw}] and valid bool [{B}] on the "
                             "front's device")
        valid = valid.contiguous()
        dev = rows.device
        d = self.dims

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        scratch = empty((B, 6 + 2 * d.n_msg_slots), torch.int32)
        counts = empty(B, torch.int32)
        pt = empty(2, torch.int32)
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
            valid.data_ptr(), B, K,
            self._kspread.data_ptr(),
            pm.data_ptr() if pm is not None else None,
            pp.data_ptr() if pp is not None else None,
            self._salts.data_ptr(), self._inv_codes, len(self._codes),
            *self._bounds, scratch.data_ptr(),
            counts.data_ptr(), out.en.data_ptr(), out.ovf.data_ptr(),
            out.pruned.data_ptr(), pt.data_ptr(), out.lane_id.data_ptr(),
            out.kvalid.data_ptr(),
            out.kh.data_ptr(), out.kl.data_ptr(), out.krows.data_ptr(),
            out.cons_ok.data_ptr(), out.inv.data_ptr(),
            out.parent_hi.data_ptr(), out.parent_lo.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "chunk_front_launch")
        launches += 1
        return out

