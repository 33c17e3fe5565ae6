"""The v4 chunk front: its contract and its plain PyTorch version.

The front of the JAX package's v4 chunk (``ops/chunk_front_pallas.py``
``build_front``): for a window of B parent rows it runs the v2 masks
with the pack guard, the optional partial-order reduction, the
progress-limited compaction to K lanes, and on those lanes the delta
fingerprints, the successor rows, the constraint, the invariant id and
the parents' fingerprints.  ``front_plain(rows, valid, ...)`` returns the
14 outputs of the JAX kernel, in its order (``FrontOut``):

- ``en``, ``ovf``  [B, G] bool, after the progress limit (rows >= P clear);
- ``pruned``       [B, G] bool, the lanes the POR step removed, before the
                   progress limit (all False without POR arrays);
- ``P``, ``total`` 0-dim int32 device tensors (compaction, as
                   ``ops/compact_cuda.py``);
- ``lane_id``      [K] int32 flat ``b * G + g``, ``kspread`` in dead slots;
- ``kvalid``       [K] bool ``arange(K) < total``;
- ``kh``, ``kl``   [K] int64 holding the uint32 fingerprint lanes;
- ``krows``        [K, sw] uint8 successor rows;
- ``cons_ok``      [K] bool, the state constraint (True without one);
- ``inv``          [K] int64, the first violated invariant, -1 where all hold;
- ``parent_hi``, ``parent_lo`` [K] int64, each lane's parent fingerprint.

The POR step (``chunk_front_pallas.py`` ``_math1``): in each row with an
enabled certified lane (``por_mask``) only the lane of least
``por_priority`` stays, the lowest ``g`` on ties (``argmin``); the others
move to ``pruned``.  The CUDA kernel (``csrc/chunk_front.cu``) leaves the
seven per-lane outputs ``kh``..``parent_lo`` unwritten on dead lanes
(``lane >= total``), so they are compared on live lanes only.

The front comes in two halves around the seen-set insert, as the kernel
runs it: ``keys_plain`` gives every output but the successors
(``krows``, ``cons_ok`` and ``inv`` hold zeros, False and -1), and
``build_plain`` writes those three on the live lanes of a mask, in place.
``front_plain`` is the keys and the build over every live lane; the v4
step builds only the lanes the insert found new (``engine/chunk.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.reconfig import ReconfigDims, is_joint
from ..models.schema import flatten_state, gather_states, unflatten_state
from .compact_cuda import compact_plain


class FrontOut(NamedTuple):
    en: torch.Tensor
    ovf: torch.Tensor
    pruned: torch.Tensor
    P: torch.Tensor
    total: torch.Tensor
    lane_id: torch.Tensor
    kvalid: torch.Tensor
    kh: torch.Tensor
    kl: torch.Tensor
    krows: torch.Tensor
    cons_ok: torch.Tensor
    inv: torch.Tensor
    parent_hi: torch.Tensor
    parent_lo: torch.Tensor


#: The outputs a kernel may leave unwritten on dead compacted lanes.
LIVE_ONLY = ("kh", "kl", "krows", "cons_ok", "inv", "parent_hi",
             "parent_lo")


def por_keep(en, por_mask, por_priority):
    """[B, G] bool: the lanes the POR step keeps."""
    B, G = en.shape
    amp = en & por_mask[None, :]
    pri = torch.where(amp, por_priority[None, :].to(torch.int64),
                      2147483647)
    sel = pri.argmin(1)                 # the first minimum, as jnp.argmin
    lanes = torch.arange(G, device=en.device)
    return torch.where(amp.any(1)[:, None], lanes[None, :] == sel[:, None],
                       torch.ones_like(en))


def keys_plain(rows, valid, *, dims, v2, K, kspread, por_mask=None,
               por_priority=None) -> FrontOut:
    """Plain version of the keys half: ``front_plain``'s outputs but the
    successors, which hold zeros (``krows``), False (``cons_ok``) and -1
    (``inv``) on every lane until ``build_plain`` writes them."""
    B = rows.shape[0]
    G = dims.n_instances
    dev = rows.device
    states = unflatten_state(rows, dims)
    en, ovf = v2.masks(states)
    en = en & valid[:, None]
    ovf = ovf & valid[:, None]
    if por_mask is not None:
        keep = por_keep(en, por_mask, por_priority)
        pruned = en & ~keep
        en = en & keep
        ovf = ovf & keep
    else:
        pruned = torch.zeros_like(en)
    pt, lane_id, kvalid = compact_plain(en, K, kspread)
    ptaken = torch.arange(B, device=dev) < pt[0]
    en = en & ptaken[:, None]
    ovf = ovf & ptaken[:, None]

    lane = lane_id.to(torch.int64)
    pidx = lane // G
    ph = v2.parent_hash(states)
    kph = type(ph)(*(f.index_select(0, pidx) for f in ph))
    kh, kl, _ = v2.lane_out(gather_states(states, pidx), kph, lane % G,
                            successors=False)
    php, plp = v2.parent_fp(ph)
    return FrontOut(en=en, ovf=ovf, pruned=pruned, P=pt[0], total=pt[1],
                    lane_id=lane_id, kvalid=kvalid, kh=kh, kl=kl,
                    krows=torch.zeros((K, rows.shape[1]), dtype=torch.uint8,
                                      device=dev),
                    cons_ok=torch.zeros(K, dtype=torch.bool, device=dev),
                    inv=torch.full((K,), -1, dtype=torch.int64, device=dev),
                    parent_hi=php[pidx], parent_lo=plp[pidx])


def build_plain(rows, fo: FrontOut, mask, *, dims, v2, constraint=None,
                inv_id=None, built=None):
    """Plain version of the build half: the successors of the live lanes
    of ``mask`` ([K] bool) written into ``fo.krows``, ``fo.cons_ok`` and
    ``fo.inv`` in place (the constraint True and the id -1 without them);
    ``built`` ([1] or [2] int32), where given, counts those lanes in its
    first word, and in a second, where it has one, those of them in which
    some server's latest config entry is joint (``models/reconfig.py
    is_joint``; none for the spec).  Returns ``fo.cons_ok``."""
    G = dims.n_instances
    idx = (mask & fo.kvalid).nonzero().squeeze(1)
    if built is not None:
        built[:1].add_(idx.shape[0])
    if idx.shape[0] == 0:
        return fo.cons_ok
    lane = fo.lane_id.index_select(0, idx).to(torch.int64)
    states = unflatten_state(rows, dims)
    _, _, succ = v2.lane_out(gather_states(states, lane // G), None,
                             lane % G, hashes=False)
    fo.krows[idx] = flatten_state(succ, dims)
    if built is not None and built.numel() == 2 \
            and isinstance(dims, ReconfigDims):
        built[1:].add_(is_joint(succ, dims).sum().to(built.dtype))
    fo.cons_ok[idx] = constraint(succ) if constraint is not None else True
    if inv_id is not None:
        fo.inv[idx] = inv_id(succ)
    return fo.cons_ok


def front_plain(rows, valid, *, dims, v2, K, kspread, constraint=None,
                inv_id=None, por_mask=None, por_priority=None) -> FrontOut:
    """Plain version: the keys, then the build over every live lane."""
    fo = keys_plain(rows, valid, dims=dims, v2=v2, K=K, kspread=kspread,
                    por_mask=por_mask, por_priority=por_priority)
    build_plain(rows, fo, fo.kvalid, dims=dims, v2=v2,
                constraint=constraint, inv_id=inv_id)
    return fo
