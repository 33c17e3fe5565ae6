"""The v2 (delta) successor pipeline on batched tensors.

The JAX package's ``models/actions2.py`` ``build_v2``, ported to PyTorch:

1. ``masks(st) -> (enabled [X, G], overflow [X, G])`` — the action guards
   with no state construction, the pack guard folded in as overflow bits;
2. ``parent_hash(st) -> ParentHash`` — the fingerprint's internal sums per
   parent (ordered-part ``base``, bag ``msum``, per-slot hashes);
3. ``lane_out(st, ph, g) -> (hi, lo, successor)`` — for one compacted lane
   per row: the delta fingerprint and the successor, written sparsely;
4. ``parent_fp(ph) -> (hi, lo)``.

Every function runs on all rows at once: the JAX per-state code under
``vmap`` becomes a leading row axis, its scalar lookups ``st.term[i]``
become gathers.  Guards and helpers take per-lane index tensors of shape
``[X, R]`` (R lanes per state row); ``lane_out`` uses R = 1.  The
semantics are the JAX package's line for line (same deliberate spec
details: the AppendEntriesAlreadyDone hidden guard, UpdateTerm leaving the
message in flight, one-entry truncation), so masks, fingerprints and
successor rows are bit-identical to it.

Two simplifications that change no value: the three reply sends of a
Receive share one slot resolution (their guards are mutually exclusive, so
resolving the one reply row that can fire is the same as resolving all
three and selecting), and a lane's send resolution is one call with the
discard gated by ``reply_fire`` (an ungated discard is the plain send).
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fingerprint import (MASK32, constants, finalize, flat_ordered,
                               fmix32, mul32, remap_sentinel, slot_hash, u32)
from .dims import (AEQ, AER, CANDIDATE, FOLLOWER, LEADER, NIL, RVQ, RVR,
                   RaftDims)
from .schema import StateBatch, pack_ok


class V2Unavailable(NotImplementedError):
    """This dims variant has no v2 kernels (no or partial
    ``build_extra_v2``): a type of its own, so that only this condition,
    and no other ``NotImplementedError``, says so."""


class ParentHash(NamedTuple):
    base0: torch.Tensor   # [X]   ordered-part avalanche sum, lane 0
    base1: torch.Tensor
    msum0: torch.Tensor   # [X]   commutative bag sum, lane 0
    msum1: torch.Tensor
    sh0: torch.Tensor     # [X, M] per-slot row hash, lane 0
    sh1: torch.Tensor


class V2Pipeline(NamedTuple):
    masks: object
    parent_hash: object
    parent_fp: object
    lane_out: object


# -- batched lookups: field [X, n(, m)], per-lane indices [X, R] ------------

def _t1(a, i):
    return torch.gather(a, 1, i)


def _t2(a, i, k):
    x, n, m = a.shape
    return torch.gather(a.reshape(x, n * m), 1, i * m + k)


def _row(a, i):
    return torch.gather(a, 1, i.unsqueeze(-1).expand(-1, -1, a.shape[2]))


def _set1(a, i, v):
    """a[x, i] = v per lane; a [X, n], i/v [X, 1]."""
    ar = torch.arange(a.shape[1], device=a.device)
    return torch.where(ar[None, :] == i, v, a)


def _add1(a, i, d):
    ar = torch.arange(a.shape[1], device=a.device)
    return torch.where(ar[None, :] == i, a + d, a)


def _setrow(a, i, row):
    """a[x, i, :] = row; a [X, n, m], i [X, 1], row [X, 1, m]."""
    ar = torch.arange(a.shape[1], device=a.device)
    return torch.where((ar[None, :] == i).unsqueeze(-1), row, a)


def _set2(a, i, k, v):
    """a[x, i, k] = v; a [X, n, m], i/k/v [X, 1]."""
    an = torch.arange(a.shape[1], device=a.device)
    am = torch.arange(a.shape[2], device=a.device)
    mask = ((an[None, :, None] == i.unsqueeze(-1))
            & (am[None, None, :] == k.unsqueeze(-1)))
    return torch.where(mask, v.unsqueeze(-1), a)


def _first_true(mask):
    """Index of the first True along the last axis, 0 when none (argmax
    over a bool vector)."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device)
    first = torch.where(mask, ar, n).min(-1).values
    return torch.where(first == n, 0, first)


def _w(c, a, b):
    """Lane-scalar select that broadcasts over trailing row axes."""
    while c.dim() < a.dim():
        c = c.unsqueeze(-1)
    return torch.where(c, a, b)


def build_v2(dims: RaftDims, device) -> V2Pipeline:
    N, V, L, M, W = (dims.n_servers, dims.n_values, dims.max_log,
                     dims.n_msg_slots, dims.msg_width)
    consts = constants(dims, device)
    G = dims.n_instances

    O_TERM = 0
    O_ROLE = N
    O_VOTED = 2 * N
    O_LT = 3 * N
    O_LV = 3 * N + N * L
    O_LL = 3 * N + 2 * N * L
    O_CI = 4 * N + 2 * N * L
    O_VR = 5 * N + 2 * N * L
    O_VG = 6 * N + 2 * N * L
    O_NI = 7 * N + 2 * N * L
    O_MI = 7 * N + 2 * N * L + N * N

    quorum = dims.build_quorum()

    # -- fingerprint deltas -------------------------------------------------
    def contrib(pos, val, lane):
        c_ord, _, seed = consts[lane]
        return fmix32((mul32(u32(val), c_ord[pos]) + seed) & MASK32)

    def dpos(pos, old, new):
        return tuple((contrib(pos, new, ln) - contrib(pos, old, ln))
                     & MASK32 for ln in (0, 1))

    def dvec(pos, olds, news):
        """Delta over consecutive positions: pos [X, 1, n] absolute."""
        return tuple(((contrib(pos, news, ln) - contrib(pos, olds, ln))
                      .sum(-1)) & MASK32 for ln in (0, 1))

    def row_hash(mvec, lane):
        _, c_msg, seed = consts[lane]
        return slot_hash(mvec.unsqueeze(-2), c_msg, seed).squeeze(-1)

    def dsum(*deltas):
        return tuple(sum(d[ln] for d in deltas) & MASK32 for ln in (0, 1))

    # The delta toolkit a variant's extra families get (dims.build_extra_v2)
    # for their fingerprint deltas.
    fp_helpers = types.SimpleNamespace(
        dpos=dpos, dvec=dvec, dsum=dsum, ZD=(0, 0), L=L,
        O_TERM=O_TERM, O_ROLE=O_ROLE, O_VOTED=O_VOTED, O_LT=O_LT,
        O_LV=O_LV, O_LL=O_LL, O_CI=O_CI, O_VR=O_VR, O_VG=O_VG,
        O_NI=O_NI, O_MI=O_MI)
    extra_v2 = dims.build_extra_v2(fp_helpers)
    if extra_v2 is None or len(extra_v2) != len(dims.extra_families):
        raise V2Unavailable(
            f"dims {type(dims).__name__} does not provide v2 kernels for "
            "its extra families (build_extra_v2)")
    extra_v1 = dims.build_extra_kernels(device)
    extra_masks = dims.build_extra_masks_v2()
    if extra_masks is not None and len(extra_masks) != len(extra_v1):
        raise ValueError(
            f"{type(dims).__name__}.build_extra_masks_v2 returned "
            f"{len(extra_masks)} kernels for {len(extra_v1)} extra families")

    # -- shared guard/value helpers -----------------------------------------
    def last_term(st, i):
        ln = _t1(st.log_len, i)
        return torch.where(ln > 0,
                           _t2(st.log_term, i, (ln - 1).clamp(0, L - 1)),
                           0)

    def msg_row(like, cols):
        """[X, R, W] message rows from ``{column: [X, R] tensor}``."""
        z = torch.zeros_like(like)
        return torch.stack([cols.get(c, z) for c in range(W)], -1)

    def base_cols(mtype, src, dst, mterm):
        return {0: torch.full_like(mterm, mtype + 1), 1: src + 1,
                2: dst + 1, 3: mterm}

    def send_ctx(st, mvec, skip_slot=None, skip_gate=None):
        """Slot resolution of Send(mvec) per lane: mvec [X, R, W] against
        the row's bag, optionally on the post-discard view (one copy of
        ``skip_slot`` removed where ``skip_gate``) — the atomic
        discard+send of a reply."""
        cnt = st.msg_cnt.unsqueeze(1)                       # [X, 1, M]
        if skip_slot is not None:
            ar = torch.arange(M, device=cnt.device)
            dec = ((ar[None, None, :] == skip_slot.unsqueeze(-1))
                   & skip_gate.unsqueeze(-1))
            cnt = cnt - dec.to(cnt.dtype)                   # [X, R, M]
        eq = ((st.msg.unsqueeze(1) == mvec.unsqueeze(2)).all(-1)
              & (cnt > 0))                                  # [X, R, M]
        has_eq = eq.any(-1)
        free = cnt == 0
        ok = has_eq | free.any(-1)
        idx = torch.where(has_eq, _first_true(eq),
                          _first_true(free.expand_as(eq)))
        new_cnt = torch.gather(cnt.expand_as(eq), 2,
                               idx.unsqueeze(-1)).squeeze(-1) + 1
        return {"ok": ok, "idx": idx, "has_eq": has_eq,
                "pack_bad": ok & (new_cnt > 255)}

    def receive_ctx(st, s):
        """Receive(m @ slot s) guards and derived values; s [X, R]."""
        mvec = _row(st.msg, s)
        cnt_s = _t1(st.msg_cnt, s)
        occ = cnt_s > 0
        mtype = mvec[..., 0] - 1
        j = (mvec[..., 1] - 1).clamp(0, N - 1)
        i = (mvec[..., 2] - 1).clamp(0, N - 1)
        mterm = mvec[..., 3]
        t_i = _t1(st.term, i)
        role_i = _t1(st.role, i)
        ln = _t1(st.log_len, i)
        en_ut = occ & (mterm > t_i)
        le = occ & (mterm <= t_i)

        lt = last_term(st, i)
        rvq_logok = (mvec[..., 4] > lt) | ((mvec[..., 4] == lt)
                                           & (mvec[..., 5] >= ln))
        vf_i = _t1(st.voted_for, i)
        grant = ((mterm == t_i) & rvq_logok
                 & ((vf_i == NIL) | (vf_i == j + 1)))
        cols = base_cols(RVR, i, j, t_i)
        cols[4] = grant.to(mterm.dtype)
        cols[5] = ln
        lrow_t, lrow_v = _row(st.log_term, i), _row(st.log_val, i)
        for k in range(L):
            cols[6 + k] = lrow_t[..., k]
            cols[6 + L + k] = lrow_v[..., k]
        rvr_resp = msg_row(mterm, cols)
        en_rvq = le & (mtype == RVQ)
        en_rvr_drop = le & (mtype == RVR) & (mterm < t_i)
        en_rvr = le & (mtype == RVR) & (mterm == t_i)

        prev, pterm, n_ent = mvec[..., 4], mvec[..., 5], mvec[..., 6]
        eterm, eval_, mcommit = mvec[..., 7], mvec[..., 8], mvec[..., 9]
        aeq_logok = (prev == 0) | (
            (prev > 0) & (prev <= ln)
            & (pterm == _t2(st.log_term, i, (prev - 1).clamp(0, L - 1))))
        en_aeq = le & (mtype == AEQ)
        en_rej = en_aeq & ((mterm < t_i)
                           | ((mterm == t_i) & (role_i == FOLLOWER)
                              & ~aeq_logok))
        rej_resp = msg_row(mterm, base_cols(AER, i, j, t_i))
        en_rtf = en_aeq & (mterm == t_i) & (role_i == CANDIDATE)
        acc = en_aeq & (mterm == t_i) & (role_i == FOLLOWER) & aeq_logok
        index = prev + 1
        have_at = ln >= index
        term_at = _t2(st.log_term, i, (index - 1).clamp(0, L - 1))
        done_shape = (n_ent == 0) | (have_at & (term_at == eterm))
        en_done = acc & done_shape & (mcommit == _t1(st.commit, i))
        cols = base_cols(AER, i, j, t_i)
        cols[4] = torch.ones_like(mterm)
        cols[5] = prev + n_ent
        done_resp = msg_row(mterm, cols)
        en_conf = acc & (n_ent > 0) & have_at & (term_at != eterm)
        fits = ln < L
        en_noc = acc & (n_ent > 0) & (ln == prev)
        en_aer_drop = le & (mtype == AER) & (mterm < t_i)
        en_aer = le & (mtype == AER) & (mterm == t_i)
        return dict(
            mvec=mvec, cnt_s=cnt_s, i=i, j=j, mterm=mterm, ln=ln,
            grant=grant, rvr_resp=rvr_resp, rej_resp=rej_resp,
            done_resp=done_resp, eterm=eterm, eval_=eval_, mcommit=mcommit,
            en_ut=en_ut, en_rvq=en_rvq, en_rvr_drop=en_rvr_drop,
            en_rvr=en_rvr, en_rej=en_rej, en_rtf=en_rtf, en_done=en_done,
            en_conf=en_conf, en_noc=en_noc, fits=fits,
            en_aer_drop=en_aer_drop, en_aer=en_aer)

    # Per-lane index tables, on the device once: an upload per batch would
    # make the host wait for the device on every dispatch.
    ii_t = torch.arange(N, device=device).repeat_interleave(N)
    jj_t = torch.arange(N, device=device).repeat(N)
    slot_t = torch.arange(M, device=device)
    ar_n = torch.arange(N, device=device)

    def lanes(x, table):
        return table.unsqueeze(0).expand(x, -1)

    def rv_msg(st, i, j):
        cols = base_cols(RVQ, i, j, _t1(st.term, i))
        cols[4] = last_term(st, i)
        cols[5] = _t1(st.log_len, i)
        return msg_row(cols[3], cols)

    def ae_msg(st, i, j):
        """AppendEntries(i, j)'s request row; j [X, R] in 0..N-1."""
        ln = _t1(st.log_len, i)
        ni = _t2(st.next_idx, i, j)
        prev = ni - 1
        prev_term = torch.where((prev > 0) & (prev <= ln),
                                _t2(st.log_term, i,
                                    (prev - 1).clamp(0, L - 1)),
                                0)
        last_entry = torch.minimum(ln, ni)
        n_ent = (ln >= ni).to(ln.dtype)
        k = (ni - 1).clamp(0, L - 1)
        cols = base_cols(AEQ, i, j, _t1(st.term, i))
        cols[4] = prev
        cols[5] = prev_term
        cols[6] = n_ent
        cols[7] = torch.where(n_ent > 0, _t2(st.log_term, i, k), 0)
        cols[8] = torch.where(n_ent > 0, _t2(st.log_val, i, k), 0)
        cols[9] = torch.minimum(_t1(st.commit, i), last_entry)
        return msg_row(ln, cols)

    # -- guards-only masks over the whole grid ------------------------------
    def masks(st: StateBatch):
        x = st.term.shape[0]
        en_parts, ovf_parts = [], []
        zN = torch.zeros((x, N), dtype=torch.bool, device=device)
        en_parts.append(torch.ones_like(zN))                 # Restart
        ovf_parts.append(zN)
        en_t = (st.role == FOLLOWER) | (st.role == CANDIDATE)  # Timeout
        en_parts.append(en_t)
        ovf_parts.append(en_t & (st.term + 1 > 255))
        ii, jj = lanes(x, ii_t), lanes(x, jj_t)              # RequestVote
        en = ((_t1(st.role, ii) == CANDIDATE)
              & (((_t1(st.votes_resp, ii) >> jj) & 1) == 0))
        m = rv_msg(st, ii, jj)
        ctx = send_ctx(st, m)
        pack = ctx["pack_bad"] | (m[..., 4] > 127)
        en_parts.append(en & ctx["ok"])
        ovf_parts.append((en & ~ctx["ok"]) | (en & ctx["ok"] & pack))
        member = ((st.votes_gran.unsqueeze(-1)                # BecomeLeader
                   >> torch.arange(N, device=device)) & 1)
        en_parts.append((st.role == CANDIDATE)
                        & quorum(st, lanes(x, ar_n), member))
        ovf_parts.append(zN)
        is_l = st.role == LEADER                             # ClientRequest
        fits = st.log_len < L
        en_parts.append((is_l & fits).repeat_interleave(V, 1))
        ovf_parts.append((is_l & ~fits).repeat_interleave(V, 1))
        en_parts.append(is_l)                                # AdvanceCommit
        ovf_parts.append(zN)
        en = (ii != jj) & (_t1(st.role, ii) == LEADER)       # AppendEntries
        ctx = send_ctx(st, ae_msg(st, ii, jj))
        en_parts.append(en & ctx["ok"])
        ovf_parts.append((en & ~ctx["ok"])
                         | (en & ctx["ok"] & ctx["pack_bad"]))
        s = lanes(x, slot_t)                                 # Receive
        rc = receive_ctx(st, s)
        reply_en = rc["en_rvq"] | rc["en_rej"] | rc["en_done"]
        reply_row = _w(rc["en_rvq"], rc["rvr_resp"],
                       _w(rc["en_rej"], rc["rej_resp"], rc["done_resp"]))
        rctx = send_ctx(st, reply_row, skip_slot=s,
                        skip_gate=rc["cnt_s"] == 1)
        overflow = (reply_en & ~rctx["ok"]) | (rc["en_noc"] & ~rc["fits"])
        enabled = (rc["en_ut"] | rc["en_rvq"] | rc["en_rvr_drop"]
                   | rc["en_rvr"] | rc["en_rej"] | rc["en_rtf"]
                   | rc["en_done"] | rc["en_conf"] | rc["en_noc"]
                   | rc["en_aer_drop"] | rc["en_aer"]) & ~overflow
        en_parts.append(enabled)
        ovf_parts.append(overflow | (reply_en & rctx["pack_bad"]))
        occ = st.msg_cnt > 0                                 # Duplicate
        en_parts.append(occ)
        ovf_parts.append(occ & (st.msg_cnt + 1 > 255))
        en_parts.append(occ)                                 # Drop
        ovf_parts.append(torch.zeros_like(occ))
        # Extra families: the variant's guards-only masks, with one
        # pack_ok of the parent; without them, its kernels' successors
        # and their pack guard, lane by lane.
        if extra_masks is not None and extra_v1:
            pk_parent = pack_ok(st, dims)
            for (params, _kern), mask_fn in zip(extra_v1, extra_masks):
                en_e, ovf_e = mask_fn(st, pk_parent,
                                      *(lanes(x, p) for p in params))
                en_parts.append(en_e)
                ovf_parts.append(ovf_e)
        else:
            for params, kern in extra_v1:
                for c in range(params[0].shape[0]):
                    en_e, ovf_e, succ_e = kern(
                        st, *(lanes(x, p[c:c + 1]) for p in params))
                    pk = pack_ok(succ_e, dims).unsqueeze(1)
                    en_parts.append(en_e)
                    ovf_parts.append(ovf_e | (en_e & ~pk))
        return torch.cat(en_parts, 1), torch.cat(ovf_parts, 1)

    # -- fingerprint internals of the parents -------------------------------
    def parent_hash(st: StateBatch) -> ParentHash:
        flat = flat_ordered(st)
        occupied = st.msg_cnt > 0
        out = {}
        for ln in (0, 1):
            c_ord, c_msg, seed = consts[ln]
            base = fmix32((mul32(flat, c_ord) + seed) & MASK32).sum(1) \
                & MASK32
            sh = slot_hash(st.msg, c_msg, seed)
            msum = torch.where(occupied, mul32(sh, u32(st.msg_cnt)),
                               torch.zeros_like(sh)).sum(1) & MASK32
            out[ln] = (base, msum, sh)
        return ParentHash(base0=out[0][0], base1=out[1][0],
                          msum0=out[0][1], msum1=out[1][1],
                          sh0=out[0][2], sh1=out[1][2])

    def parent_fp(ph: ParentHash):
        hi = finalize(ph.base0, ph.msum0, consts[0][2])
        lo = finalize(ph.base1, ph.msum1, consts[1][2])
        return hi, remap_sentinel(hi, lo)

    # -- static grid decode tables ------------------------------------------
    fam_np = np.zeros(G, np.int64)
    p1_np = np.zeros(G, np.int64)
    p2_np = np.zeros(G, np.int64)
    for fam, (off, size) in enumerate(zip(dims.family_offsets,
                                          dims.family_sizes)):
        for k in range(size):
            g = off + k
            fam_np[g] = fam
            if fam in (0, 1, 3, 5):
                p1_np[g] = k
            elif fam in (2, 6):
                p1_np[g], p2_np[g] = k // N, k % N
            elif fam == 4:
                p1_np[g], p2_np[g] = k // V, k % V + 1
            else:
                p1_np[g] = k
    fam_t = torch.as_tensor(fam_np, device=device)
    p1_t = torch.as_tensor(p1_np, device=device)
    p2_t = torch.as_tensor(p2_np, device=device)
    idxs = torch.arange(1, L + 1, device=device)

    def lane_out(st: StateBatch, ph: ParentHash, g: torch.Tensor,
                 hashes: bool = True, successors: bool = True):
        """Delta fingerprint + sparse successor for grid instance ``g[x]``
        of parent row x.  Only meaningful on enabled lanes.  With
        ``hashes=False`` the fingerprint is not computed (``ph`` may be
        None) and ``hi``, ``lo`` are None: the walk tiers hash the one
        successor they take in full, as the JAX package's do.  With
        ``successors=False`` the successor is not built and is None: the
        v4 front's keys hash every lane and build only the new ones."""
        g = g.unsqueeze(1)                                   # [X, 1]
        fam = fam_t[g]
        # Reads clamp, as JAX gathers do: a slot family's p1 is a slot
        # index, read as a server only under gates that are off for it.
        i = p1_t[g].clamp(0, N - 1)
        jv = p2_t[g]
        s = p1_t[g]
        s_rd = s.clamp(0, M - 1)
        rc = receive_ctx(st, s_rd)

        is_restart, is_timeout = fam == 0, fam == 1
        is_rv, is_bl, is_cr = fam == 2, fam == 3, fam == 4
        is_ac, is_ae, is_recv = fam == 5, fam == 6, fam == 7
        is_dup, is_drop = fam == 8, fam == 9

        term_i = _t1(st.term, i)
        ln_i = _t1(st.log_len, i)
        ri, rj = rc["i"], rc["j"]

        ut_fire = is_recv & rc["en_ut"]
        term_tgt = torch.where(is_timeout, i, ri)
        term_new = torch.where(is_timeout, term_i + 1, rc["mterm"])
        term_wr = is_timeout | ut_fire

        role_tgt = torch.where(is_recv, ri, i)
        role_new = torch.where(is_restart, FOLLOWER, torch.where(
            is_timeout, CANDIDATE, torch.where(is_bl, LEADER, FOLLOWER)))
        role_wr = (is_restart | is_timeout | is_bl
                   | (is_recv & (rc["en_ut"] | rc["en_rtf"])))

        grant_fire = is_recv & rc["en_rvq"] & rc["grant"]
        voted_tgt = torch.where(is_timeout, i, ri)
        voted_new = torch.where(grant_fire, rj + 1, NIL)
        voted_wr = is_timeout | ut_fire | grant_fire

        cr_k = ln_i.clamp(0, L - 1)
        conf_k = (rc["ln"] - 1).clamp(0, L - 1)
        noc_k = rc["ln"].clamp(0, L - 1)
        conf_fire = is_recv & rc["en_conf"]
        noc_fire = is_recv & rc["en_noc"]
        log_tgt_i = torch.where(is_cr, i, ri)
        log_k = torch.where(is_cr, cr_k, torch.where(conf_fire, conf_k, noc_k))
        log_t_new = torch.where(is_cr, term_i,
                                torch.where(conf_fire, 0, rc["eterm"]))
        log_v_new = torch.where(is_cr, jv,
                                torch.where(conf_fire, 0, rc["eval_"]))
        ll_new = torch.where(conf_fire, rc["ln"] - 1,
                             torch.where(is_cr, ln_i + 1, rc["ln"] + 1))
        log_wr = is_cr | conf_fire | noc_fire

        mi_row = _row(st.match_idx, i)                      # [X, 1, N]
        member = ((mi_row.unsqueeze(2) >= idxs[None, None, :, None])
                  | (ar_n[None, None, None, :] == i[..., None, None]))
        agree_ok = (quorum(st, i, member)
                    & (idxs[None, None, :] <= ln_i.unsqueeze(-1)))
        any_ok = agree_ok.any(-1)
        max_agree = torch.where(agree_ok, idxs, 0).max(-1).values
        own_term = _t2(st.log_term, i, (max_agree - 1).clamp(0, L - 1)) \
            == term_i
        ac_commit = torch.where(any_ok & own_term, max_agree,
                                _t1(st.commit, i))
        done_fire = is_recv & rc["en_done"]
        commit_tgt = torch.where(is_recv, ri, i)
        commit_new = torch.where(is_restart, 0,
                                 torch.where(is_ac, ac_commit, rc["mcommit"]))
        commit_wr = is_restart | is_ac | done_fire

        rvr_fire = is_recv & rc["en_rvr"]
        granted_bit = torch.where(rc["mvec"][..., 4] > 0, 1, 0) << rj
        vr_tgt = torch.where(is_recv, ri, i)
        vr_new = torch.where(rvr_fire, _t1(st.votes_resp, ri) | (1 << rj), 0)
        vg_new = torch.where(rvr_fire, _t1(st.votes_gran, ri) | granted_bit, 0)
        votes_wr = is_restart | is_timeout | rvr_fire

        ni_row_new = torch.where(is_restart.unsqueeze(-1),
                                 torch.ones_like(mi_row),
                                 (ln_i + 1).unsqueeze(-1).expand_as(mi_row))
        mi_row_new = torch.zeros_like(mi_row)
        rows_wr = is_restart | is_bl
        aer_fire = is_recv & rc["en_aer"]
        succ_flag = rc["mvec"][..., 4] > 0
        mmatch = rc["mvec"][..., 5]
        ni_rr = _t2(st.next_idx, ri, rj)
        mi_rr = _t2(st.match_idx, ri, rj)
        ni_cell_new = torch.where(succ_flag, mmatch + 1,
                                  torch.clamp(ni_rr - 1, min=1))
        mi_cell_new = torch.where(succ_flag, mmatch, mi_rr)

        # ---- bag edits ----
        j_srv = jv.clamp(0, N - 1)        # AE reads clamp, as JAX gathers do
        rvq_fire = is_recv & rc["en_rvq"]
        rej_fire = is_recv & rc["en_rej"]
        reply_fire = rvq_fire | rej_fire | done_fire
        disc_only = is_recv & (rc["en_rvr_drop"] | rc["en_rvr"]
                               | rc["en_aer_drop"] | rc["en_aer"])
        do_discard = reply_fire | disc_only | is_drop
        do_send = is_rv | is_ae | reply_fire
        send_row = _w(is_rv, rv_msg(st, i, jv), _w(
            is_ae, ae_msg(st, i, j_srv), _w(
                rvq_fire, rc["rvr_resp"],
                _w(rej_fire, rc["rej_resp"], rc["done_resp"]))))
        sctx = send_ctx(st, send_row, skip_slot=s,
                        skip_gate=reply_fire & (rc["cnt_s"] == 1))

        # Extra-family lanes: every base *_wr gate above is off on them,
        # so the base deltas are zero and the base successor is the
        # parent; the variant's deltas and successors fold in by family.
        extra_out = []
        for e, ((params_e, _kern), lane_fn) in enumerate(
                zip(extra_v1, extra_v2)):
            f = 10 + e
            local = (g - dims.family_offsets[f]).clamp(
                0, dims.family_sizes[f] - 1)
            extra_out.append((fam == f, lane_fn(
                st, *(p[local] for p in params_e))))

        # ---- delta fingerprint (skipped where the caller hashes the
        # successor itself) ----
        hi = lo = None
        if hashes:
            def keep(wr, new, old):
                return torch.where(wr, new, old)

            old = _t1(st.term, term_tgt)
            d = [dpos(O_TERM + term_tgt, old, keep(term_wr, term_new, old))]
            old = _t1(st.role, role_tgt)
            d.append(dpos(O_ROLE + role_tgt, old,
                          keep(role_wr, role_new, old)))
            old = _t1(st.voted_for, voted_tgt)
            d.append(dpos(O_VOTED + voted_tgt, old,
                          keep(voted_wr, voted_new, old)))
            old = _t2(st.log_term, log_tgt_i, log_k)
            d.append(dpos(O_LT + log_tgt_i * L + log_k, old,
                          keep(log_wr, log_t_new, old)))
            old = _t2(st.log_val, log_tgt_i, log_k)
            d.append(dpos(O_LV + log_tgt_i * L + log_k, old,
                          keep(log_wr, log_v_new, old)))
            old = _t1(st.log_len, log_tgt_i)
            d.append(dpos(O_LL + log_tgt_i, old, keep(log_wr, ll_new, old)))
            old = _t1(st.commit, commit_tgt)
            d.append(dpos(O_CI + commit_tgt, old,
                          keep(commit_wr, commit_new, old)))
            old = _t1(st.votes_resp, vr_tgt)
            d.append(dpos(O_VR + vr_tgt, old, keep(votes_wr, vr_new, old)))
            old = _t1(st.votes_gran, vr_tgt)
            d.append(dpos(O_VG + vr_tgt, old, keep(votes_wr, vg_new, old)))
            ni_row = _row(st.next_idx, i)
            row_pos = i.unsqueeze(-1) * N + ar_n
            d.append(dvec(O_NI + row_pos, ni_row,
                          _w(rows_wr, ni_row_new, ni_row)))
            d.append(dvec(O_MI + row_pos, mi_row,
                          _w(rows_wr, mi_row_new, mi_row)))
            d.append(dpos(O_NI + ri * N + rj, ni_rr,
                          keep(aer_fire, ni_cell_new, ni_rr)))
            d.append(dpos(O_MI + ri * N + rj, mi_rr,
                          keep(aer_fire, mi_cell_new, mi_rr)))
            for is_e, (dbe, _dm, _succ) in extra_out:
                d.append(tuple(torch.where(is_e, x, 0) for x in dbe))
            db0 = sum(a for a, _b in d) & MASK32
            db1 = sum(b for _a, b in d) & MASK32

            sh_s = (_t1(ph.sh0, s_rd), _t1(ph.sh1, s_rd))
            sh_eq = (_t1(ph.sh0, sctx["idx"]), _t1(ph.sh1, sctx["idx"]))
            dm = []
            for ln in (0, 1):
                d_send = torch.where(sctx["has_eq"], sh_eq[ln],
                                     row_hash(send_row, ln))
                zero = torch.zeros_like(d_send)
                dm_ln = (torch.where(do_discard, -sh_s[ln], zero)
                         + torch.where(do_send & sctx["ok"], d_send, zero)
                         + torch.where(is_dup, sh_s[ln], zero))
                for is_e, (_db, dme, _succ) in extra_out:
                    dm_ln = dm_ln + torch.where(is_e, dme[ln], zero)
                dm.append(dm_ln & MASK32)

            hi = finalize((ph.base0.unsqueeze(1) + db0) & MASK32,
                          (ph.msum0.unsqueeze(1) + dm[0]) & MASK32,
                          consts[0][2])
            lo = finalize((ph.base1.unsqueeze(1) + db1) & MASK32,
                          (ph.msum1.unsqueeze(1) + dm[1]) & MASK32,
                          consts[1][2])
            lo = remap_sentinel(hi, lo)
        if not successors:
            return hi.squeeze(1), lo.squeeze(1), None

        # ---- sparse successor construction ----
        term_o = _w(term_wr, _set1(st.term, term_tgt, term_new), st.term)
        role_o = _w(role_wr, _set1(st.role, role_tgt, role_new), st.role)
        voted_o = _w(voted_wr, _set1(st.voted_for, voted_tgt, voted_new),
                     st.voted_for)
        lt_o = _w(log_wr, _set2(st.log_term, log_tgt_i, log_k, log_t_new),
                  st.log_term)
        lv_o = _w(log_wr, _set2(st.log_val, log_tgt_i, log_k, log_v_new),
                  st.log_val)
        ll_o = _w(log_wr, _set1(st.log_len, log_tgt_i, ll_new), st.log_len)
        ci_o = _w(commit_wr, _set1(st.commit, commit_tgt, commit_new),
                  st.commit)
        vr_o = _w(votes_wr, _set1(st.votes_resp, vr_tgt, vr_new),
                  st.votes_resp)
        vg_o = _w(votes_wr, _set1(st.votes_gran, vr_tgt, vg_new),
                  st.votes_gran)
        ni_o = _w(rows_wr, _setrow(st.next_idx, i, ni_row_new),
                  _w(aer_fire, _set2(st.next_idx, ri, rj, ni_cell_new),
                     st.next_idx))
        mi_o = _w(rows_wr, _setrow(st.match_idx, i, mi_row_new),
                  _w(aer_fire, _set2(st.match_idx, ri, rj, mi_cell_new),
                     st.match_idx))

        msg_o, cnt_o = st.msg, st.msg_cnt
        d_cnt = _add1(cnt_o, s, -1)
        keep_row = _w(_t1(d_cnt, s_rd) > 0, _row(msg_o, s_rd),
                      torch.zeros_like(send_row))
        d_msg = _setrow(msg_o, s, keep_row)
        msg_o = _w(do_discard, d_msg, msg_o)
        cnt_o = _w(do_discard, d_cnt, cnt_o)
        idx = sctx["idx"]
        row = _w(sctx["has_eq"] | ~sctx["ok"], _row(msg_o, idx), send_row)
        s_msg = _setrow(msg_o, idx, row)
        s_cnt = _add1(cnt_o, idx, torch.where(sctx["ok"], 1, 0))
        msg_o = _w(do_send, s_msg, msg_o)
        cnt_o = _w(do_send, s_cnt, cnt_o)
        cnt_o = _w(is_dup, _add1(cnt_o, s, 1), cnt_o)

        succ = StateBatch(term=term_o, role=role_o, voted_for=voted_o,
                          log_term=lt_o, log_val=lv_o, log_len=ll_o,
                          commit=ci_o, votes_resp=vr_o, votes_gran=vg_o,
                          next_idx=ni_o, match_idx=mi_o,
                          msg=msg_o, msg_cnt=cnt_o)
        for is_e, (_db, _dm, succ_e) in extra_out:
            succ = StateBatch(*(_w(is_e, a, b) for a, b in zip(succ_e, succ)))
        if not hashes:
            return None, None, succ
        return hi.squeeze(1), lo.squeeze(1), succ

    return V2Pipeline(masks=masks, parent_hash=parent_hash,
                      parent_fp=parent_fp, lane_out=lane_out)
