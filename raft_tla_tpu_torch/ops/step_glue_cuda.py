"""The chunk step's bookkeeping: the CUDA kernels ``csrc/step_glue.cu`` and
their wrappers.

Replaces no TPU kernel: in the JAX package XLA fuses these lines into the
chunk's ``while_loop`` body.  Their plain versions are ``engine/chunk.py``
``ChunkStep.cond``, ``window`` and ``update`` and ``ChunkStages.finish``,
which the step runs on CPU tensors; on CUDA tensors it calls these
wrappers, which launch the kernels or raise:

- ``step_begin(glue, qcur, seen, st) -> (a [1] bool, rows [B, sw] uint8,
  valid [B] bool)``: the cond and the window, one launch;
- ``step_cond(glue, seen, st)``: the cond alone into ``st[glue.cur + 2]``
  (the word a burst of steps ends with), one launch of the same kernel,
  counted with ``step_begin``'s;
- ``step_end(glue, a, rows, valid, fo, new, fail, count, seen, cs)``: the
  batch's counters, its first violation and deadlock into the
  ``ChunkState`` (nothing but the queue count and the seen size when ``a``
  is false), one launch; ``fo`` is the front's ``FrontOut``, ``fo.pruned``
  read only when ``glue.por``.

Each is bit-exact against its plain version.  ``step_begin.launches`` and
``step_end.launches`` count the launches.  A ``StepGlue`` holds what the
launches of one ``ChunkStep`` share: its shapes, the cond's words, the
family of each grid instance and the end launch's scratch (a ticket and
sums, left as it was found after each launch).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import build


def _launches(fn):
    fn.launches = 0
    return fn


@functools.cache
def geometry(F: int):
    """``(scratch words for F families, most families, most cond words)``
    of the built kernels."""
    out = (ctypes.c_int * 3)()
    _lib().step_glue_geometry(F, out)
    return tuple(out)


def launch_info(B: int, sw: int, K: int):
    """``{kernel: build.kernel_info}`` of the two launches of a step."""
    return {name: build.kernel_info("step_glue", i, B, sw, K)
            for i, name in enumerate(KERNELS)}


#: The CUDA launches of a step, in order.
KERNELS = ("step_begin_kernel", "step_end_kernel")


def _lib():
    lib = build.library("step_glue")
    if lib.step_begin_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.step_begin_launch.restype = ctypes.c_int
        lib.step_begin_launch.argtypes = [p, p, p, i, i, i, p, ll, p, ll, i,
                                          i, p, p, p, p, p]
        lib.step_end_launch.restype = ctypes.c_int
        lib.step_end_launch.argtypes = [p] * 18 + [i] * 5 + [p] * 6
        lib.step_glue_geometry.restype = None
        lib.step_glue_geometry.argtypes = [i, p]
    return lib


class StepGlue:
    """What the two launches of one ``ChunkStep`` share.

    ``words`` and ``lims``: the cond ``st[words[j]] <= lims[j]`` for each
    j, where the first two limits are ``st[cur] - 1`` and ``st[cur + 1] -
    1`` (the level's rows, the step limit; ``lims``' first two entries
    are not read), and the seen set at most half full.  ``count_word``
    holds the level's row count the window is valid below.
    ``family_of`` [G]: each grid instance's action family."""

    def __init__(self, *, B: int, K: int, sw: int, family_of, words, lims,
                 cur: int, count_word: int, por: bool, device):
        if len(words) != len(lims) or len(words) < 2:
            raise ValueError("step glue: one limit a cond word, two or more")
        fam = np.asarray(family_of, np.int64)
        self.B, self.K, self.sw = B, K, sw
        self.G, self.F = len(fam), int(fam.max()) + 1
        self.cur, self.count_word, self.por = cur, count_word, por
        self.words = (ctypes.c_int * len(words))(*words)
        self.lims = (ctypes.c_int * len(lims))(*lims)
        self.device = torch.device(device)
        self.family_of = torch.as_tensor(fam.astype(np.int32),
                                         device=self.device)
        #: The end launch's scratch (on the card only).
        self.scratch = (self._make_scratch() if self.device.type == "cuda"
                        else None)

    def _make_scratch(self) -> torch.Tensor:
        if torch.cuda.is_current_stream_capturing():
            # A capture would record the fill below, not run it.
            raise RuntimeError("step glue: made inside a graph capture")
        words, most_f, most_cond = geometry(self.F)
        if self.F > most_f or len(self.words) > most_cond:
            raise ValueError(
                f"step glue: {self.F} families and {len(self.words)} cond "
                f"words, the kernels take {most_f} and {most_cond}")
        sc = torch.zeros(words, dtype=torch.int32, device=self.device)
        # Words 4 and 5 (SC_VIOL, SC_DEAD): no violating lane, no dead
        # row yet.
        sc[4:6] = 2**31 - 1
        return sc


def _check(glue: StepGlue, what: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev} (the plain "
                         "version is engine/chunk.py ChunkStep's)")
    if any(t.device != dev for t in tensors + (glue.family_of,)):
        raise ValueError(f"{what}: arguments on different devices")
    return dev


def _state_args(glue: StepGlue, seen, st):
    if (st.dtype != torch.int32 or not st.is_contiguous()
            or st.shape[0] < glue.cur + 3):
        raise ValueError("step glue: st must be a contiguous int32 "
                         "ChunkState.st")
    if seen.size.dtype != torch.int64 or seen.size.numel() != 1:
        raise ValueError("step glue: seen.size must be one int64")
    return (st.data_ptr(), glue.words, glue.lims, len(glue.words), glue.cur,
            glue.count_word, seen.size.data_ptr(), seen.capacity // 2)


@_launches
def step_begin(glue: StepGlue, qcur: torch.Tensor, seen, st: torch.Tensor):
    """``(a, rows, valid)``; see the module contract."""
    dev = _check(glue, "step_begin", qcur, st, seen.size)
    B, sw = glue.B, glue.sw
    if (qcur.dtype != torch.uint8 or qcur.dim() != 2 or qcur.shape[1] != sw
            or not qcur.is_contiguous()):
        raise ValueError(f"step_begin: qcur must be contiguous uint8 "
                         f"[rows, {sw}]")
    a = torch.empty(1, dtype=torch.bool, device=dev)
    rows = torch.empty((B, sw), dtype=torch.uint8, device=dev)
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    err = _lib().step_begin_launch(
        *_state_args(glue, seen, st), qcur.data_ptr(), qcur.shape[0], sw, B,
        rows.data_ptr(), valid.data_ptr(), a.data_ptr(), None,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "step_begin_launch")
    step_begin.launches += 1
    return a, rows, valid


def step_cond(glue: StepGlue, seen, st: torch.Tensor) -> None:
    """The cond into ``st[glue.cur + 2]``; see the module contract."""
    dev = _check(glue, "step_cond", st, seen.size)
    err = _lib().step_begin_launch(
        *_state_args(glue, seen, st), None, 0, glue.sw, 0, None, None, None,
        st[glue.cur + 2:].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "step_begin_launch")
    step_begin.launches += 1


def _flags(t, shape, what):
    if t.dtype != torch.bool or tuple(t.shape) != shape:
        raise ValueError(f"step_end: {what} must be bool {list(shape)}")
    return t.contiguous()


@_launches
def step_end(glue: StepGlue, a, rows, valid, fo, new, fail, count, seen,
             cs) -> None:
    """The batch into ``cs``; see the module contract."""
    B, K, G, sw = glue.B, glue.K, glue.G, glue.sw
    st = cs.st
    dev = _check(glue, "step_end", a, rows, valid, fo.en, fo.ovf, fo.P,
                 fo.lane_id, new, fo.inv, fo.kh, fo.kl, fo.krows, fail,
                 count, seen.size, st, cs.vrow, cs.vfp, cs.drow)
    en = _flags(fo.en, (B, G), "en")
    ovf = _flags(fo.ovf, (B, G), "ovf")
    pruned = _flags(fo.pruned, (B, G), "pruned") if glue.por else None
    valid = _flags(valid, (B,), "valid")
    new = _flags(new, (K,), "new")
    _flags(a, (1,), "a")
    if (rows.dtype != torch.uint8 or rows.shape != (B, sw)
            or not rows.is_contiguous() or fo.krows.shape != (K, sw)
            or not fo.krows.is_contiguous()
            or fo.lane_id.dtype != torch.int32 or fo.lane_id.shape != (K,)
            or any(t.dtype != torch.int64 or t.shape != (K,)
                   for t in (fo.inv, fo.kh, fo.kl))
            or fo.P.dtype != torch.int32 or fo.total.dtype != torch.int32
            or count.dtype != torch.int32 or count.numel() != 1
            or fail.dtype != torch.bool or fail.numel() != 1
            or cs.vrow.shape != (sw,) or cs.drow.shape != (sw,)
            or cs.vfp.dtype != torch.int64 or cs.vfp.shape != (2,)):
        raise ValueError("step_end: the front's, the tail's or the chunk "
                         "state's tensors are not as the step makes them")
    _state_args(glue, seen, st)             # checks st and seen.size
    err = _lib().step_end_launch(
        a.data_ptr(), valid.data_ptr(), rows.data_ptr(), en.data_ptr(),
        ovf.data_ptr(), pruned.data_ptr() if pruned is not None else None,
        fo.P.data_ptr(), fo.total.data_ptr(),
        fo.lane_id.contiguous().data_ptr(), new.data_ptr(),
        fo.inv.contiguous().data_ptr(), fo.kh.contiguous().data_ptr(),
        fo.kl.contiguous().data_ptr(), fo.krows.data_ptr(), fail.data_ptr(),
        count.data_ptr(), seen.size.data_ptr(), glue.family_of.data_ptr(),
        B, G, K, glue.F, sw, st.data_ptr(), cs.vrow.data_ptr(),
        cs.vfp.data_ptr(), cs.drow.data_ptr(), glue.scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "step_end_launch")
    step_end.launches += 1
