"""Joint-consensus membership reconfiguration (``configs/reconfig3.cfg``).

The JAX package's ``models/reconfig.py``, as PyTorch functions on batched
tensors.  The spec models a fixed membership; this variant extends it the
way the Raft paper's joint consensus does, with every existing action
unchanged (they dispatch through the ``RaftDims`` hooks):

- **Configurations ride in the log.**  ``CFG_BASE + (old << 8) + new`` is
  the joint configuration C_old,new and ``CFG_BASE + new`` (old bits zero)
  the final configuration C_new; client values 1..V are untouched, so
  config entries replicate and truncate through AppendEntries like any
  other entry.
- **A server uses the latest configuration in its own log**, committed or
  not, and the full membership when its log holds none.
- **Quorums**: under a joint configuration a majority of C_old and a
  majority of C_new; under a final one a majority of it (``build_quorum``
  in place of the simple majority).
- **InitiateReconfig(i, c)**: a leader whose configuration is final (one
  change at a time) appends the joint entry C_current,c for a target
  ``c != current``.
- **FinalizeReconfig(i)**: a leader whose configuration is the joint
  C_old,new, with its commitIndex at that entry, appends C_new.

The targets a leader may move to are the model constant ``TargetConfigs``
(membership bitmasks over the interned server order).  Joint values reach
36,735 for 7 servers, so the packed row carries value high-byte planes
(``value_bytes`` 2, ``models/schema.py``).

Index tensors are per lane, ``[X, R]`` (R lanes a state row), as in
``models/actions2.py``.  The JAX package's pure-Python successor function
(``extra_successors_py``) belongs to its oracle, which the port does not
have.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .actions2 import _add1, _row, _set2, _t1, _t2
from .dims import LEADER, RaftDims

# Log values >= CFG_BASE are configuration entries, below are client values.
CFG_BASE = 1 << 12

A_INITRECONFIG = 10
A_FINALIZE = 11


def joint_value(old_mask: int, new_mask: int) -> int:
    """Log value of the joint entry C_old,new."""
    return CFG_BASE + (old_mask << 8) + new_mask


def final_value(new_mask: int) -> int:
    """Log value of the final entry C_new."""
    return CFG_BASE + new_mask


def config_of_py(log, n: int) -> Tuple[int, int, int]:
    """(old_mask, new_mask, index) of the latest config entry in ``log``;
    old_mask 0 means final.  Default: the full membership at index 0."""
    for idx in range(len(log), 0, -1):
        v = log[idx - 1][1]
        if v >= CFG_BASE:
            enc = v - CFG_BASE
            return (enc >> 8) & 0xFF, enc & 0xFF, idx
    return 0, (1 << n) - 1, 0


@dataclasses.dataclass(frozen=True)
class ReconfigDims(RaftDims):
    """RaftDims + joint-consensus reconfiguration over ``targets`` (the
    TargetConfigs membership bitmasks a leader may move to)."""

    targets: Tuple[int, ...] = ()

    def __post_init__(self):
        full = (1 << self.n_servers) - 1
        if self.n_servers > 7:
            # CFG_BASE + (old << 8) + new needs 17 bits with 8-bit masks;
            # checked before the lane audit so the rule is what is named.
            raise ValueError("ReconfigDims supports at most 7 servers "
                             "(2-byte log-value packing)")
        super().__post_init__()
        if not self.targets:
            raise ValueError("ReconfigDims needs at least one target config")
        for c in self.targets:
            if not (1 <= c <= full):
                raise ValueError(
                    f"target config {c:#x} not a nonempty subset of the "
                    f"{self.n_servers} servers")

    @property
    def max_log_value(self) -> int:
        """A joint entry with both masks full: <= 36,735 for n <= 7."""
        full = (1 << self.n_servers) - 1
        return CFG_BASE + (full << 8) + full

    @property
    def value_bytes(self) -> int:
        """Config entries exceed uint8: CFG_BASE and ``old << 8`` are
        multiples of 256, so in one byte a joint or final entry would
        alias the client value ``new_mask``."""
        return 2

    # -- grid -------------------------------------------------------------
    @property
    def extra_families(self) -> tuple:
        n, c = self.n_servers, len(self.targets)
        return (("InitiateReconfig", n * c), ("FinalizeReconfig", n))

    def instance_info(self, g: int) -> tuple:
        base = sum(self.family_sizes[:10])
        if g < base:
            return super().instance_info(g)
        k = g - base
        nc = self.n_servers * len(self.targets)
        if k < nc:
            i, t = divmod(k, len(self.targets))
            return A_INITRECONFIG, {"i": i, "c": self.targets[t]}
        k -= nc
        if k < self.n_servers:
            return A_FINALIZE, {"i": k}
        raise IndexError(g)

    # -- quorum (joint rule) ----------------------------------------------
    def build_quorum(self):
        config_scan = _build_config_scan(self)
        N = self.n_servers

        def quorum(st, i, member):
            old, new, _idx = config_scan(st, i)
            ar = torch.arange(N, device=member.device)
            mem = member.bool()
            extra = (1,) * (member.dim() - 1 - old.dim())

            def maj(mask):
                bits = ((mask.view(mask.shape + extra + (1,)) >> ar) & 1) > 0
                return 2 * (mem & bits).sum(-1) > bits.sum(-1)

            o = old.view(old.shape + extra)
            return torch.where(o > 0, maj(old) & maj(new), maj(new))

        return quorum

    def quorum_py(self, s, i: int, mask: int) -> bool:
        old, new, _idx = config_of_py(s.log[i], self.n_servers)

        def maj(cfg: int) -> bool:
            return 2 * bin(mask & cfg).count("1") > bin(cfg).count("1")

        return (maj(old) and maj(new)) if old else maj(new)

    # -- the two actions --------------------------------------------------
    def _append_entry(self, st, i, val):
        """(fits, successor) of appending ``(term[i], val)`` to log[i];
        ``i``, ``val`` [X, 1]."""
        L = self.max_log
        ln = _t1(st.log_len, i)
        kpos = ln.clamp(0, L - 1)
        return ln < L, st._replace(
            log_term=_set2(st.log_term, i, kpos, _t1(st.term, i)),
            log_val=_set2(st.log_val, i, kpos, val),
            log_len=_add1(st.log_len, i, 1))

    def _build_guards(self):
        """The one source of the two guards and their appended values,
        shared by the extra kernels, the v2 lanes and the v2 masks."""
        config_scan = _build_config_scan(self)

        def initiate(st, i, c):
            """Leader with a final config appends C_current,c."""
            old, new, _idx = config_scan(st, i)
            en = (_t1(st.role, i) == LEADER) & (old == 0) & (c != new)
            return en, CFG_BASE + (new << 8) + c

        def finalize(st, i):
            """Leader whose committed joint config C_old,new appends
            C_new."""
            old, new, idx = config_scan(st, i)
            en = ((_t1(st.role, i) == LEADER) & (old > 0)
                  & (_t1(st.commit, i) >= idx))
            return en, CFG_BASE + new

        return initiate, finalize

    def build_extra_kernels(self, device):
        init_g, fin_g = self._build_guards()
        N, C = self.n_servers, len(self.targets)

        def initiate(st, i, c):
            en, val = init_g(st, i, c)
            fits, succ = self._append_entry(st, i, val)
            return en & fits, en & ~fits, succ

        def finalize(st, i):
            en, val = fin_g(st, i)
            fits, succ = self._append_entry(st, i, val)
            return en & fits, en & ~fits, succ

        targets = torch.tensor(self.targets, dtype=torch.int64,
                               device=device)
        ii = torch.arange(N, device=device).repeat_interleave(C)
        cc = targets.repeat(N)
        servers = torch.arange(N, device=device)
        return [((ii, cc), initiate), ((servers,), finalize)]

    def build_extra_v2(self, fp):
        """Both actions append one entry at (i, Len(log[i])): the
        fingerprint delta is three ordered positions, the bag is
        untouched, and the successor is ``_append_entry``'s."""
        init_g, fin_g = self._build_guards()
        L = self.max_log

        def append_delta_succ(st, i, val):
            ln = _t1(st.log_len, i)
            k = ln.clamp(0, L - 1)
            d_base = fp.dsum(
                fp.dpos(fp.O_LT + i * L + k, _t2(st.log_term, i, k),
                        _t1(st.term, i)),
                fp.dpos(fp.O_LV + i * L + k, _t2(st.log_val, i, k), val),
                fp.dpos(fp.O_LL + i, ln, ln + 1))
            _fits, succ = self._append_entry(st, i, val)
            return d_base, fp.ZD, succ

        def initiate(st, i, c):
            _en, val = init_g(st, i, c)
            return append_delta_succ(st, i, val)

        def finalize(st, i):
            _en, val = fin_g(st, i)
            return append_delta_succ(st, i, val)

        return [initiate, finalize]

    def build_extra_masks_v2(self):
        """Guards only: the appended value (<= 36,735) fits its 2-byte
        lane, the entry's term is ``term[i]``, which the parent's pack
        guard bounds, and ``log_len`` is capped by ``max_log``, so
        ``pack_ok(successor) == pack_ok(parent)`` on every lane."""
        init_g, fin_g = self._build_guards()
        L = self.max_log

        def _append_masks(en, st, i, pk_parent):
            fits = _t1(st.log_len, i) < L
            pk = pk_parent.unsqueeze(1)
            return en & fits, (en & ~fits) | (en & fits & ~pk)

        def initiate(st, pk_parent, i, c):
            en, _val = init_g(st, i, c)
            return _append_masks(en, st, i, pk_parent)

        def finalize(st, pk_parent, i):
            en, _val = fin_g(st, i)
            return _append_masks(en, st, i, pk_parent)

        return [initiate, finalize]

    # -- TypeOK value domain ----------------------------------------------
    def build_value_ok(self):
        v, n = self.n_values, self.n_servers
        full = (1 << n) - 1

        def value_ok(vals):
            client = (vals >= 1) & (vals <= v)
            enc = vals - CFG_BASE
            old = (enc >> 8) & 0xFF
            new = enc & 0xFF
            cfg = ((vals >= CFG_BASE)
                   & (enc <= (full << 8) + full)
                   & (new >= 1) & (new <= full) & (old <= full))
            return client | cfg

        return value_ok

    def value_ok_py(self, val: int) -> bool:
        if 1 <= val <= self.n_values:
            return True
        if val >= CFG_BASE:
            enc = val - CFG_BASE
            old, new = (enc >> 8) & 0xFF, enc & 0xFF
            full = (1 << self.n_servers) - 1
            return enc >> 16 == 0 and 1 <= new <= full and old <= full
        return False


def _build_config_scan(dims: ReconfigDims):
    """``config_scan(st, i)``: the latest config entry of server i's log as
    (old_mask, new_mask, 1-based index), each [X, R]; (0, full, 0) when
    the log holds none."""
    N, L = dims.n_servers, dims.max_log
    full = (1 << N) - 1

    def config_scan(st, i):
        vals = _row(st.log_val, i)                          # [X, R, L]
        lanes = torch.arange(L, device=vals.device)
        is_cfg = ((lanes < _t1(st.log_len, i).unsqueeze(-1))
                  & (vals >= CFG_BASE))
        has = is_cfg.any(-1)
        k = torch.where(is_cfg, lanes, -1).max(-1).values
        enc = torch.gather(vals, 2, k.clamp(0, L - 1).unsqueeze(-1)) \
            .squeeze(-1) - CFG_BASE
        old = torch.where(has, (enc >> 8) & 0xFF, 0)
        new = torch.where(has, enc & 0xFF, full)
        return old, new, torch.where(has, k + 1, 0)

    return config_scan
