// The v2 Raft model as device code, for the v4 chunk front (chunk_front.cu).
//
// Line for line the port's models/actions2.py (itself the JAX package's
// models/actions2.py), on one state at a time:
//   - the packed uint8 row of models/schema.py, decoded into ints in shared
//     memory (message column 4, mprevLogIndex, sign-extended);
//   - the guards of `masks` with the pack guard as overflow bits, through
//     `send_ctx` / `receive_ctx`;
//   - the fingerprint pieces of ops/fingerprint.py: per-position
//     contributions, slot hashes, `finalize`, the sentinel remap;
//   - the registry predicates TypeOK, NoLeaderElected and BoundedSpace
//     (models/invariants.py) and the nine of the safety suite
//     (models/safety.py), each on one state by a whole warp;
//   - the joint-consensus reconfiguration variant (models/reconfig.py) in
//     the builds with kReconfig: two more families (InitiateReconfig over
//     N x targets, FinalizeReconfig over N), the config scan of a
//     server's own log, the joint quorum in BecomeLeader and
//     AdvanceCommitIndex, TypeOK's widened value domain, and 2-byte log
//     values: the row's high-byte planes are added on decode, so a value
//     position of the decoded ints holds the whole value (a plane position
//     holds its raw byte), and a write of a value position writes its
//     plane too.  So the safety suite, which reads values only through
//     St::lv and St::msg at value positions, compares whole values, config
//     entries included, in the variant's suite build (kSuite, kReconfig).
// Values are ints, as the PyTorch version's int64 fields are: a successor
// value that does not fit its uint8 lane is kept whole for the hash and the
// predicates and wraps only when the row is written, as flatten_state does.
// Every read clamps its index exactly where the PyTorch version does (JAX
// gathers clamp, plain loads do not).  Fingerprint sums wrap mod 2^32 in
// native uint32 arithmetic.
#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kMaxN = 8;                  // models/dims.py (bitmask lanes)
constexpr int kMaxL = 16;                 // max_log this kernel supports
constexpr int kMaxW = 4 + 2 + 2 * kMaxL;  // msg_width at kMaxL
constexpr int kMaxM = 256;                // message slots
constexpr int kMaxInv = 16;               // invariants per run, 4 bits each
                                          // in a 64-bit list
constexpr int kNFam = 10;                 // the spec's families
constexpr int kMaxFam = 12;               // with the reconfig variant's two
constexpr int kMaxTargets = 32;           // TargetConfigs the kernel takes
constexpr int CFG_BASE = 1 << 12;         // models/reconfig.py

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, NIL = 0;
constexpr int RVQ = 0, RVR = 1, AEQ = 2, AER = 3;

// Predicate codes (ops/chunk_front_cuda.py PREDICATES): TypeOK and the
// canary, then the safety suite in models/safety.py's order.
constexpr int PRED_TYPE_OK = 1, PRED_NO_LEADER = 2, PRED_MESSAGES = 3,
              PRED_LEADER_VOTES_QUORUM = 4, PRED_CANDIDATE_TERM_NOT_IN_LOG = 5,
              PRED_ELECTION_SAFETY = 6, PRED_LOG_MATCHING = 7,
              PRED_VOTES_GRANTED = 8, PRED_QUORUM_LOG = 9,
              PRED_MORE_UP_TO_DATE = 10, PRED_LEADER_COMPLETENESS = 11;
constexpr int kNumPred = 11;

struct Dims {
  int N, V, L, M, W, G, D, sw;
  // byte offsets of the row's fields (models/schema.py order)
  int o_term, o_role, o_voted, o_lt, o_lv, o_ll, o_ci, o_vr, o_vg, o_ni,
      o_mi, o_msg, o_cnt;
  int f_off[kMaxFam + 1];  // family offsets in the instance grid, then G
  // The reconfig variant (T > 0): its targets, and the high-byte planes
  // of the log values (o_lvh, [N, L]) and of the message value columns
  // (o_mvh, [M, n_vc]: column 8 and [6 + L, 6 + 2L), in column order).
  int T, tg[kMaxTargets];
  int o_lvh, o_mvh, n_vc;
};

// T = 0: the spec; T > 0: the reconfig variant over targets[0..T).
inline Dims make_dims(int N, int V, int L, int M, int T = 0,
                      const int* targets = nullptr) {
  Dims d;
  d.N = N;
  d.V = V;
  d.L = L;
  d.M = M;
  d.W = 4 + (6 > 2 + 2 * L ? 6 : 2 + 2 * L);
  d.o_term = 0;
  d.o_role = N;
  d.o_voted = 2 * N;
  d.o_lt = 3 * N;
  d.o_lv = 3 * N + N * L;
  d.o_ll = 3 * N + 2 * N * L;
  d.o_ci = 4 * N + 2 * N * L;
  d.o_vr = 5 * N + 2 * N * L;
  d.o_vg = 6 * N + 2 * N * L;
  d.o_ni = 7 * N + 2 * N * L;
  d.o_mi = 7 * N + 2 * N * L + N * N;
  d.D = 7 * N + 2 * N * L + 2 * N * N;  // the fingerprint's ordered part
  d.o_msg = d.D;
  d.o_cnt = d.D + M * d.W;
  d.sw = d.o_cnt + M;
  d.T = T;
  for (int t = 0; t < kMaxTargets; ++t)
    d.tg[t] = t < T && targets ? targets[t] : 0;
  const bool col8_apart = 8 < 6 + L || 8 >= 6 + 2 * L;
  d.n_vc = L + (col8_apart ? 1 : 0);
  d.o_lvh = d.sw;
  d.o_mvh = d.o_lvh + N * L;
  if (T > 0) d.sw = d.o_mvh + M * d.n_vc;
  const int sizes[kMaxFam] = {N, N, N * N, N, N * V, N, N * N, M, M, M,
                              N * T, N};
  const int nfam = T > 0 ? kMaxFam : kNFam;
  int acc = 0;
  for (int f = 0; f < nfam; ++f) {
    d.f_off[f] = acc;
    acc += sizes[f];
  }
  for (int f = nfam; f <= kMaxFam; ++f) d.f_off[f] = acc;
  d.G = acc;
  return d;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The index of message column c among the value columns (its place in a
// slot's high-byte plane), -1 for another column (schema.py
// `_msg_value_cols`: column 8 and [6 + L, 6 + 2L), sorted).
__host__ __device__ __forceinline__ int value_col(const Dims& d, int c) {
  const int lo = 6 + d.L, hi = 6 + 2 * d.L;
  if (c >= lo && c < hi) return c - lo + (8 < lo ? 1 : 0);
  if (c == 8) return 8 < lo ? 0 : hi - lo;
  return -1;
}

// The high-byte position of base position p, -1 where p holds no value
// (the reconfig variant's rows).
__device__ __forceinline__ int value_hi(const Dims& d, int p) {
  if (p >= d.o_lv && p < d.o_lv + d.N * d.L) return d.o_lvh + (p - d.o_lv);
  if (p >= d.o_msg && p < d.o_cnt) {
    const int s = (p - d.o_msg) / d.W;
    const int v = value_col(d, p - d.o_msg - s * d.W);
    if (v >= 0) return d.o_mvh + s * d.n_vc + v;
  }
  return -1;
}

// Decode one packed row into ints (a warp's share: lanes stride the row).
// kReconfig adds each value's high-byte plane << 8 to its low byte.
template <bool kReconfig = false>
__device__ __forceinline__ void decode_row(const Dims& d,
                                           const uint8_t* __restrict__ row,
                                           int* sv, int lane) {
  for (int p = lane; p < d.sw; p += 32) {
    const int b = row[p];
    const bool col4 = p >= d.o_msg && p < d.o_cnt && (p - d.o_msg) % d.W == 4;
    int v = col4 ? (int)(int8_t)b : b;
    if constexpr (kReconfig) {
      const int h = value_hi(d, p);
      if (h >= 0) v += (int)row[h] << 8;
    }
    sv[p] = v;
  }
}

// One state: the decoded row in shared memory.
struct St {
  const Dims& d;
  const int* v;
  __device__ int term(int i) const { return v[d.o_term + i]; }
  __device__ int role(int i) const { return v[d.o_role + i]; }
  __device__ int voted(int i) const { return v[d.o_voted + i]; }
  __device__ int lt(int i, int k) const { return v[d.o_lt + i * d.L + k]; }
  __device__ int lv(int i, int k) const { return v[d.o_lv + i * d.L + k]; }
  __device__ int ll(int i) const { return v[d.o_ll + i]; }
  __device__ int ci(int i) const { return v[d.o_ci + i]; }
  __device__ int vr(int i) const { return v[d.o_vr + i]; }
  __device__ int vg(int i) const { return v[d.o_vg + i]; }
  __device__ int ni(int i, int j) const { return v[d.o_ni + i * d.N + j]; }
  __device__ int mi(int i, int j) const { return v[d.o_mi + i * d.N + j]; }
  __device__ int msg(int s, int c) const { return v[d.o_msg + s * d.W + c]; }
  __device__ int cnt(int s) const { return v[d.o_cnt + s]; }

  __device__ int last_term(int i) const {
    const int ln = ll(i);
    return ln > 0 ? lt(i, clampi(ln - 1, 0, d.L - 1)) : 0;
  }
};

// -- message rows (msg_row / base_cols of actions2.py) ----------------------

__device__ __forceinline__ void base_cols(const Dims& d, int* m, int mtype,
                                          int src, int dst, int mterm) {
  for (int c = 0; c < d.W; ++c) m[c] = 0;
  m[0] = mtype + 1;
  m[1] = src + 1;
  m[2] = dst + 1;
  m[3] = mterm;
}

__device__ __forceinline__ void rv_msg(const St& st, int i, int j, int* m) {
  base_cols(st.d, m, RVQ, i, j, st.term(i));
  m[4] = st.last_term(i);
  m[5] = st.ll(i);
}

// AppendEntries(i, j)'s request row; j in 0..N-1.
__device__ __forceinline__ void ae_msg(const St& st, int i, int j, int* m) {
  const int L = st.d.L;
  const int ln = st.ll(i);
  const int ni = st.ni(i, j);
  const int prev = ni - 1;
  const int prev_term =
      (prev > 0 && prev <= ln) ? st.lt(i, clampi(prev - 1, 0, L - 1)) : 0;
  const int last_entry = min(ln, ni);
  const int n_ent = ln >= ni ? 1 : 0;
  const int k = clampi(ni - 1, 0, L - 1);
  base_cols(st.d, m, AEQ, i, j, st.term(i));
  m[4] = prev;
  m[5] = prev_term;
  m[6] = n_ent;
  m[7] = n_ent > 0 ? st.lt(i, k) : 0;
  m[8] = n_ent > 0 ? st.lv(i, k) : 0;
  m[9] = min(st.ci(i), last_entry);
}

__device__ __forceinline__ bool row_equal(const St& st, int t, const int* m) {
  for (int c = 0; c < st.d.W; ++c)
    if (st.msg(t, c) != m[c]) return false;
  return true;
}

// -- Receive(m @ slot s): guards and derived values (receive_ctx) -----------

struct Recv {
  int cnt_s, i, j, mterm, t_i, ln, m4, m5, prev, n_ent, eterm, evalue,
      mcommit;
  bool grant, en_ut, en_rvq, en_rvr_drop, en_rvr, en_rej, en_rtf, en_done,
      en_conf, en_noc, fits, en_aer_drop, en_aer;
};

__device__ __forceinline__ Recv receive_ctx(const St& st, int s) {
  const Dims& d = st.d;
  Recv r;
  r.cnt_s = st.cnt(s);
  const bool occ = r.cnt_s > 0;
  const int mtype = st.msg(s, 0) - 1;
  r.j = clampi(st.msg(s, 1) - 1, 0, d.N - 1);
  r.i = clampi(st.msg(s, 2) - 1, 0, d.N - 1);
  r.mterm = st.msg(s, 3);
  const int i = r.i;
  r.t_i = st.term(i);
  const int role_i = st.role(i);
  r.ln = st.ll(i);
  r.en_ut = occ && r.mterm > r.t_i;
  const bool le = occ && r.mterm <= r.t_i;

  r.m4 = st.msg(s, 4);
  r.m5 = st.msg(s, 5);
  const int lt = st.last_term(i);
  const bool rvq_logok = r.m4 > lt || (r.m4 == lt && r.m5 >= r.ln);
  const int vf = st.voted(i);
  r.grant = r.mterm == r.t_i && rvq_logok && (vf == NIL || vf == r.j + 1);
  r.en_rvq = le && mtype == RVQ;
  r.en_rvr_drop = le && mtype == RVR && r.mterm < r.t_i;
  r.en_rvr = le && mtype == RVR && r.mterm == r.t_i;

  r.prev = r.m4;
  const int pterm = r.m5;
  r.n_ent = st.msg(s, 6);
  r.eterm = st.msg(s, 7);
  r.evalue = st.msg(s, 8);
  r.mcommit = st.msg(s, 9);
  const bool aeq_logok =
      r.prev == 0 || (r.prev > 0 && r.prev <= r.ln &&
                      pterm == st.lt(i, clampi(r.prev - 1, 0, d.L - 1)));
  const bool en_aeq = le && mtype == AEQ;
  r.en_rej = en_aeq && (r.mterm < r.t_i || (r.mterm == r.t_i &&
                                            role_i == FOLLOWER && !aeq_logok));
  r.en_rtf = en_aeq && r.mterm == r.t_i && role_i == CANDIDATE;
  const bool acc =
      en_aeq && r.mterm == r.t_i && role_i == FOLLOWER && aeq_logok;
  const int index = r.prev + 1;
  const bool have_at = r.ln >= index;
  const int term_at = st.lt(i, clampi(index - 1, 0, d.L - 1));
  const bool done_shape = r.n_ent == 0 || (have_at && term_at == r.eterm);
  r.en_done = acc && done_shape && r.mcommit == st.ci(i);
  r.en_conf = acc && r.n_ent > 0 && have_at && term_at != r.eterm;
  r.fits = r.ln < d.L;
  r.en_noc = acc && r.n_ent > 0 && r.ln == r.prev;
  r.en_aer_drop = le && mtype == AER && r.mterm < r.t_i;
  r.en_aer = le && mtype == AER && r.mterm == r.t_i;
  return r;
}

// The reply a Receive sends: RequestVoteResponse when en_rvq, else the
// rejecting or the accepting AppendEntriesResponse.
__device__ __forceinline__ void reply_row(const St& st, const Recv& r,
                                          bool rvq, bool rej, int* m) {
  const Dims& d = st.d;
  if (rvq) {
    base_cols(d, m, RVR, r.i, r.j, r.t_i);
    m[4] = r.grant ? 1 : 0;
    m[5] = r.ln;
    for (int k = 0; k < d.L; ++k) {
      m[6 + k] = st.lt(r.i, k);
      m[6 + d.L + k] = st.lv(r.i, k);
    }
  } else {
    base_cols(d, m, AER, r.i, r.j, r.t_i);
    if (!rej) {
      m[4] = 1;
      m[5] = r.prev + r.n_ent;
    }
  }
}

// -- Send(m): slot resolution against the bag (send_ctx) --------------------

struct Send {
  bool ok, has_eq, pack_bad;
  int idx;
};

// The resolution from the first equal occupied slot and the first free
// slot (-1 for none) of the view: _first_true gives slot 0 when there is
// neither.
__device__ __forceinline__ Send resolve_send(const St& st, int first_eq,
                                             int first_free, int skip_slot,
                                             bool skip_gate) {
  Send r;
  r.has_eq = first_eq >= 0;
  r.ok = r.has_eq || first_free >= 0;
  r.idx = r.has_eq ? first_eq : (first_free >= 0 ? first_free : 0);
  const int new_cnt =
      st.cnt(r.idx) - ((skip_gate && r.idx == skip_slot) ? 1 : 0) + 1;
  r.pack_bad = r.ok && new_cnt > 255;
  return r;
}

// One thread resolves one send; `skip_gate` removes one copy of slot
// `skip_slot` first (the atomic discard + send of a reply).
__device__ __forceinline__ Send send_ctx(const St& st, const int* m,
                                         int skip_slot, bool skip_gate) {
  int first_eq = -1, first_free = -1;
  for (int t = 0; t < st.d.M; ++t) {
    const int c = st.cnt(t) - ((skip_gate && t == skip_slot) ? 1 : 0);
    if (c > 0) {
      if (first_eq < 0 && row_equal(st, t, m)) first_eq = t;
    } else if (c == 0 && first_free < 0) {
      first_free = t;
    }
  }
  return resolve_send(st, first_eq, first_free, skip_slot, skip_gate);
}

// The same resolution by a whole warp, one lane per slot: every lane
// passes the same `m` and gets the same result.
__device__ __forceinline__ Send send_ctx_warp(const St& st, const int* m,
                                              int skip_slot, bool skip_gate,
                                              int lane) {
  int first_eq = -1, first_free = -1;
  for (int base = 0; base < st.d.M; base += 32) {
    const int t = base + lane;
    bool e = false, f = false;
    if (t < st.d.M) {
      const int c = st.cnt(t) - ((skip_gate && t == skip_slot) ? 1 : 0);
      if (c > 0)
        e = row_equal(st, t, m);
      else
        f = c == 0;
    }
    const unsigned be = __ballot_sync(0xffffffffu, e);
    const unsigned bf = __ballot_sync(0xffffffffu, f);
    if (first_eq < 0 && be) first_eq = base + __ffs(be) - 1;  // __ffs: 1-based
    if (first_free < 0 && bf) first_free = base + __ffs(bf) - 1;
  }
  return resolve_send(st, first_eq, first_free, skip_slot, skip_gate);
}

// -- the instance grid ------------------------------------------------------

struct Inst {
  int fam, k, p1, p2;  // family, index in it, decoded parameters
};

// kReconfig: InitiateReconfig(i, c) (p1 = i, p2 = the target c, in
// ReconfigDims.instance_info's order) and FinalizeReconfig(i) (p1 = i).
template <bool kReconfig = false>
__device__ __forceinline__ Inst decode_instance(const Dims& d, int g) {
  constexpr int nfam = kReconfig ? kMaxFam : kNFam;
  Inst r;
  r.fam = 0;
  while (r.fam + 1 < nfam && g >= d.f_off[r.fam + 1]) ++r.fam;
  r.k = g - d.f_off[r.fam];
  r.p1 = r.k;
  r.p2 = 0;
  if (r.fam == 2 || r.fam == 6) {
    r.p1 = r.k / d.N;
    r.p2 = r.k % d.N;
  } else if (r.fam == 4) {
    r.p1 = r.k / d.V;
    r.p2 = r.k % d.V + 1;
  } else if (kReconfig && r.fam == kNFam) {
    r.p1 = r.k / d.T;
    r.p2 = d.tg[r.k % d.T];
  }
  return r;
}

// -- the reconfig variant (models/reconfig.py) -------------------------------

// The latest config entry of server i's own log (committed or not):
// (old mask, new mask, 1-based index); (0, full, 0) when it holds none.
struct Config {
  int old_m, new_m, idx;
};

__device__ __forceinline__ Config config_scan(const St& st, int i) {
  const int L = st.d.L, ln = st.ll(i);
  int kk = -1;
  for (int k = 0; k < L; ++k)
    if (k < ln && st.lv(i, k) >= CFG_BASE) kk = k;
  if (kk < 0) return Config{0, (1 << st.d.N) - 1, 0};
  const int enc = st.lv(i, kk) - CFG_BASE;
  return Config{(enc >> 8) & 0xFF, enc & 0xFF, kk + 1};
}

// Whether some server's latest config entry is joint (C_old,new): the
// states in which BecomeLeader and AdvanceCommitIndex take majorities of
// both configurations.  By a whole warp, a server a lane.
__device__ __forceinline__ bool joint_warp(const St& st, int lane) {
  bool joint = false;
  for (int i = lane; i < st.d.N; i += 32) joint |= config_scan(st, i).old_m > 0;
  return __any_sync(0xffffffffu, joint);
}

// Is the server bitmask `member` a quorum from server i's view: the
// spec's simple majority, or under kReconfig the joint rule (majorities
// of C_old and of C_new under a joint entry, of C_new under a final one).
template <bool kReconfig = false>
__device__ __forceinline__ bool quorum(const St& st, int i, int member) {
  const int N = st.d.N;
  if constexpr (!kReconfig) {
    return 2 * __popc(member) > N;
  } else {
    const int full = (1 << N) - 1;
    const Config c = config_scan(st, i);
    auto maj = [&](int cfg) {
      return 2 * __popc(member & cfg & full) > __popc(cfg & full);
    };
    return c.old_m > 0 ? maj(c.old_m) && maj(c.new_m) : maj(c.new_m);
  }
}

// The value InitiateReconfig(i, c) (fam 10) or FinalizeReconfig(i) appends,
// and whether its guard holds (the one-at-a-time rule; the joint entry
// committed).
__device__ __forceinline__ bool reconfig_guard(const St& st, const Inst& in,
                                               int* val) {
  const int i = in.p1;
  const Config c = config_scan(st, i);
  const bool lead = st.role(i) == LEADER;
  if (in.fam == kNFam) {
    *val = CFG_BASE + (c.new_m << 8) + in.p2;
    return lead && c.old_m == 0 && in.p2 != c.new_m;
  }
  *val = CFG_BASE + c.new_m;
  return lead && c.old_m > 0 && st.ci(i) >= c.idx;
}

// TypeOK's value domain: a client value, or a config entry whose masks
// are nonempty (new) subsets of the servers (ReconfigDims.build_value_ok).
__device__ __forceinline__ bool reconfig_value_ok(const Dims& d, int v) {
  const int full = (1 << d.N) - 1;
  const int enc = v - CFG_BASE;
  const int old_m = (enc >> 8) & 0xFF, new_m = enc & 0xFF;
  return (v >= 1 && v <= d.V) ||
         (v >= CFG_BASE && enc <= (full << 8) + full && new_m >= 1 &&
          new_m <= full && old_m <= full);
}

// The guard of instance g with its pack guard: (enabled, overflow), as
// actions2.py `masks` computes them lane by lane.
template <bool kReconfig = false>
__device__ __forceinline__ void guard(const St& st, int g, bool* en_out,
                                      bool* ovf_out) {
  const Dims& d = st.d;
  const Inst in = decode_instance<kReconfig>(d, g);
  if constexpr (kReconfig) {
    if (in.fam >= kNFam) {
      // One entry appended at (i, Len(log[i])).  The pack guard of the
      // successor equals the parent's (the value fits its 2-byte lane, the
      // term is term[i]), and that holds on every row decoded from bytes:
      // so overflow is only a full log.
      int val;
      const bool want = reconfig_guard(st, in, &val);
      const bool fits = st.ll(in.p1) < d.L;
      *en_out = want && fits;
      *ovf_out = want && !fits;
      return;
    }
  }
  bool en = false, ovf = false;
  int m[kMaxW];
  switch (in.fam) {
    case 0:  // Restart
      en = true;
      break;
    case 1: {  // Timeout
      const int i = in.k;
      en = st.role(i) == FOLLOWER || st.role(i) == CANDIDATE;
      ovf = en && st.term(i) + 1 > 255;
      break;
    }
    case 2: {  // RequestVote(i, j)
      const int i = in.p1, j = in.p2;
      const bool want =
          st.role(i) == CANDIDATE && ((st.vr(i) >> j) & 1) == 0;
      if (want) {
        rv_msg(st, i, j, m);
        const Send c = send_ctx(st, m, -1, false);
        const bool pack = c.pack_bad || m[4] > 127;
        en = c.ok;
        ovf = !c.ok || pack;
      }
      break;
    }
    case 3: {  // BecomeLeader
      const int i = in.k;
      en = st.role(i) == CANDIDATE &&
           quorum<kReconfig>(st, i, st.vg(i) & ((1 << d.N) - 1));
      break;
    }
    case 4: {  // ClientRequest(i, v)
      const int i = in.p1;
      const bool is_l = st.role(i) == LEADER, fits = st.ll(i) < d.L;
      en = is_l && fits;
      ovf = is_l && !fits;
      break;
    }
    case 5:  // AdvanceCommitIndex
      en = st.role(in.k) == LEADER;
      break;
    case 6: {  // AppendEntries(i, j)
      const int i = in.p1, j = in.p2;
      if (i != j && st.role(i) == LEADER) {
        ae_msg(st, i, j, m);
        const Send c = send_ctx(st, m, -1, false);
        en = c.ok;
        ovf = !c.ok || c.pack_bad;
      }
      break;
    }
    case 7: {  // Receive(slot s)
      const int s = in.k;
      const Recv r = receive_ctx(st, s);
      const bool reply_en = r.en_rvq || r.en_rej || r.en_done;
      bool reply_ok = true, reply_pack = false;
      if (reply_en) {
        reply_row(st, r, r.en_rvq, r.en_rej, m);
        const Send c = send_ctx(st, m, s, r.cnt_s == 1);
        reply_ok = c.ok;
        reply_pack = c.pack_bad;
      }
      const bool overflow = (reply_en && !reply_ok) || (r.en_noc && !r.fits);
      en = (r.en_ut || r.en_rvq || r.en_rvr_drop || r.en_rvr || r.en_rej ||
            r.en_rtf || r.en_done || r.en_conf || r.en_noc ||
            r.en_aer_drop || r.en_aer) &&
           !overflow;
      ovf = overflow || (reply_en && reply_pack);
      break;
    }
    case 8: {  // DuplicateMessage(slot s)
      const int c = st.cnt(in.k);
      en = c > 0;
      ovf = en && c + 1 > 255;
      break;
    }
    default:  // DropMessage(slot s)
      en = st.cnt(in.k) > 0;
      break;
  }
  *en_out = en;
  *ovf_out = ovf;
}

// -- fingerprint (ops/fingerprint.py) ----------------------------------------
//
// Salt tables, uploaded once per engine as uint32:
//   [seed0, seed1, c_ord0[D], c_ord1[D], c_msg0[W], c_msg1[W]].

struct Salts {
  const uint32_t* p;
  int D, W;
  __device__ uint32_t seed(int ln) const { return p[ln]; }
  __device__ uint32_t c_ord(int ln, int pos) const {
    return p[2 + ln * D + pos];
  }
  __device__ uint32_t c_msg(int ln, int c) const {
    return p[2 + 2 * D + ln * W + c];
  }
};

__device__ __forceinline__ uint32_t contrib(const Salts& k, int ln, int pos,
                                            int val) {
  return fmix32((uint32_t)val * k.c_ord(ln, pos) + k.seed(ln));
}

// Slot hash of one message row given as ints (slot_hash).
__device__ __forceinline__ uint32_t row_hash(const Salts& k, int ln,
                                             const int* m, int W) {
  uint32_t s = 0;
  for (int c = 0; c < W; ++c) s += (uint32_t)m[c] * k.c_msg(ln, c);
  const uint32_t seed = k.seed(ln);
  return fmix32(fmix32(s ^ seed) * 0x85EBCA6Bu + seed);
}

__device__ __forceinline__ uint32_t slot_hash(const Salts& k, int ln,
                                              const St& st, int s) {
  uint32_t h = 0;
  for (int c = 0; c < st.d.W; ++c)
    h += (uint32_t)st.msg(s, c) * k.c_msg(ln, c);
  const uint32_t seed = k.seed(ln);
  return fmix32(fmix32(h ^ seed) * 0x85EBCA6Bu + seed);
}

__device__ __forceinline__ uint32_t finalize(uint32_t base, uint32_t msum,
                                             uint32_t seed) {
  return fmix32(base + fmix32(msum + seed) * 0x9E3779B9u);
}

// The all-ones pair is the seen-set's empty key: remap its lo lane.
__device__ __forceinline__ uint32_t remap_sentinel(uint32_t hi, uint32_t lo) {
  return (hi == 0xFFFFFFFFu && lo == 0xFFFFFFFFu) ? 0xFFFFFFFEu : lo;
}

// -- predicates on one state, by a whole warp --------------------------------

template <bool kReconfig = false>
__device__ __forceinline__ bool type_ok_warp(const St& st, int lane) {
  const Dims& d = st.d;
  bool ok = true;
  for (int i = lane; i < d.N; i += 32) {
    ok &= st.role(i) >= 0 && st.role(i) <= 2;
    ok &= st.voted(i) >= 0 && st.voted(i) <= d.N;
    ok &= st.ll(i) >= 0 && st.ll(i) <= d.L;
    ok &= st.term(i) >= 0 && st.ci(i) >= 0;
    ok &= st.vr(i) >= 0 && st.vr(i) < (1 << d.N);
    ok &= st.vg(i) >= 0 && st.vg(i) < (1 << d.N);
    for (int k = 0; k < d.L; ++k) {
      const int t = st.lt(i, k), v = st.lv(i, k);
      const bool v_ok =
          kReconfig ? reconfig_value_ok(d, v) : v >= 1 && v <= d.V;
      ok &= k < st.ll(i) ? (t >= 0 && v_ok) : (t == 0 && v == 0);
    }
    for (int j = 0; j < d.N; ++j)
      ok &= st.ni(i, j) >= 1 && st.mi(i, j) >= 0;
  }
  for (int s = lane; s < d.M; s += 32) {
    if (st.cnt(s) > 0) {
      const int mt = st.msg(s, 0), src = st.msg(s, 1), dst = st.msg(s, 2);
      ok &= mt >= 1 && mt <= 4 && src >= 1 && src <= d.N && dst >= 1 &&
            dst <= d.N && st.msg(s, 3) >= 0;
    } else {
      for (int c = 0; c < d.W; ++c) ok &= st.msg(s, c) == 0;
    }
    ok &= st.cnt(s) >= 0;
  }
  return __all_sync(0xffffffffu, ok);
}

__device__ __forceinline__ bool no_leader_warp(const St& st, int lane) {
  bool ok = true;
  for (int i = lane; i < st.d.N; i += 32) ok &= st.role(i) != LEADER;
  return __all_sync(0xffffffffu, ok);
}

// -- the safety suite (models/safety.py), on one state by a whole warp ------
//
// Server pairs (i, j) sit on lanes, p = i * N + j (N <= 8: at most 64
// pairs, two passes); message slots sit on lanes for MessagesInv.  Every
// read clamps where the PyTorch version's gathers clamp.

constexpr unsigned kFull = 0xffffffffu;

// The greatest index (1-based) in log[j] whose term is t; 0 for none.
__device__ __forceinline__ int last_index_of_term(const St& st, int j,
                                                  int t) {
  const int n = min(st.ll(j), st.d.L);
  int a = 0;
  for (int l = 0; l < n; ++l)
    if (st.lt(j, l) == t) a = l + 1;
  return a;
}

// IsPrefix(Committed(a), log[b]); Committed(a) with commitIndex > Len is
// a prefix of nothing.
__device__ __forceinline__ bool committed_prefix_pair(const St& st, int a,
                                                      int b) {
  const int c = st.ci(a);
  if (c > st.ll(a) || c > st.ll(b)) return false;
  for (int l = 0; l < st.d.L && l < c; ++l)
    if (st.lt(a, l) != st.lt(b, l) || st.lv(a, l) != st.lv(b, l))
      return false;
  return true;
}

// P as a bitmask, bit a * N + b = IsPrefix(Committed(a), log[b]); the same
// on every lane.
__device__ __forceinline__ unsigned long long committed_prefix_warp(
    const St& st, int lane) {
  const int N = st.d.N;
  unsigned long long P = 0;
  for (int base = 0; base < N * N; base += 32) {
    const int p = base + lane;
    const bool v = p < N * N && committed_prefix_pair(st, p / N, p % N);
    P |= (unsigned long long)__ballot_sync(kFull, v) << base;
  }
  return P;
}

__device__ __forceinline__ bool prefix_bit(unsigned long long P, int N,
                                           int a, int b) {
  return (P >> (a * N + b)) & 1ull;
}

// MessagesInv: the four per-message invariants on every in-flight message.
__device__ __forceinline__ bool messages_inv_warp(const St& st, int lane) {
  const Dims& d = st.d;
  bool ok = true;
  for (int s = lane; s < d.M; s += 32) {
    if (st.cnt(s) <= 0) continue;
    const int mt = st.msg(s, 0) - 1, mterm = st.msg(s, 3);
    const int src = clampi(st.msg(s, 1) - 1, 0, d.N - 1);
    const int dst = clampi(st.msg(s, 2) - 1, 0, d.N - 1);
    const int t_src = st.term(src), t_dst = st.term(dst);
    const int len_src = st.ll(src), len_dst = st.ll(dst);
    const int lt_src = st.last_term(src), lt_dst = st.last_term(dst);
    const int m4 = st.msg(s, 4), m5 = st.msg(s, 5);
    ok &= mterm <= t_src;  // MessageTermsLtCurrentTerm
    if (mt == RVR && m4 > 0 && t_src == t_dst && t_src == mterm)
      ok &= lt_dst > lt_src || (lt_dst == lt_src && len_dst >= len_src);
    if (mt == RVQ && st.role(src) == CANDIDATE && t_src == mterm)
      ok &= m5 == len_src && m4 == lt_src;
    if (mt == AEQ && st.msg(s, 6) > 0 && mterm == t_src) {
      // The first conjunct is unguarded: out of the log is a violation.
      const int at1 = clampi(m4, 0, d.L - 1);
      ok &= m4 + 1 >= 1 && m4 + 1 <= len_src &&
            st.lt(src, at1) == st.msg(s, 7) && st.lv(src, at1) == st.msg(s, 8);
      if (m4 > 0 && m4 <= len_src)
        ok &= st.lt(src, clampi(m4 - 1, 0, d.L - 1)) == m5;
    }
  }
  return __all_sync(kFull, ok);
}

__device__ __forceinline__ bool leader_votes_quorum_warp(const St& st,
                                                         int lane) {
  const int N = st.d.N;
  bool ok = true;
  for (int i = lane; i < N; i += 32) {
    if (st.role(i) != LEADER) continue;
    int cnt = 0;
    for (int j = 0; j < N; ++j)
      cnt += st.term(j) > st.term(i) ||
             (st.term(j) == st.term(i) && st.voted(j) == i + 1);
    ok &= 2 * cnt > N;
  }
  return __all_sync(kFull, ok);
}

__device__ __forceinline__ bool candidate_term_not_in_log_warp(const St& st,
                                                               int lane) {
  const int N = st.d.N;
  bool ok = true;
  for (int i = lane; i < N; i += 32) {
    if (st.role(i) != CANDIDATE) continue;
    int cnt = 0;
    for (int j = 0; j < N; ++j)
      cnt += st.term(j) == st.term(i) &&
             (st.voted(j) == i + 1 || st.voted(j) == NIL);
    if (2 * cnt > N)
      for (int j = 0; j < N; ++j)
        ok &= last_index_of_term(st, j, st.term(i)) == 0;
  }
  return __all_sync(kFull, ok);
}

// The pairwise predicates, one (i, j) a lane; P is read only by the last
// four.
__device__ __forceinline__ bool pair_ok(const St& st, int code, int i, int j,
                                        unsigned long long P) {
  const int N = st.d.N;
  switch (code) {
    case PRED_ELECTION_SAFETY:  // an empty Max is 0
      return st.role(i) != LEADER ||
             last_index_of_term(st, i, st.term(i)) >=
                 last_index_of_term(st, j, st.term(i));
    case PRED_LOG_MATCHING: {
      const int n = min(min(st.ll(i), st.ll(j)), st.d.L);
      bool prefix = true;
      for (int l = 0; l < n; ++l) {
        const bool te = st.lt(i, l) == st.lt(j, l);
        prefix &= te && st.lv(i, l) == st.lv(j, l);
        if (te && !prefix) return false;
      }
      return true;
    }
    case PRED_VOTES_GRANTED:  // P[j][i]: i and j swap against QuorumLogInv
      return !(((st.vg(i) >> j) & 1) && st.term(i) == st.term(j)) ||
             prefix_bit(P, N, j, i);
    case PRED_MORE_UP_TO_DATE: {
      const int lti = st.last_term(i), ltj = st.last_term(j);
      const bool newer = lti > ltj || (lti == ltj && st.ll(i) >= st.ll(j));
      return !newer || prefix_bit(P, N, j, i);
    }
    case PRED_LEADER_COMPLETENESS:
      return st.role(i) != LEADER || prefix_bit(P, N, j, i);
    default:
      return false;
  }
}

// One predicate of the suite (codes 3..11) on one state; `P` and `have_p`
// cache the committed-prefix relation across the run's list.  A code
// outside the suite fails: chunk_front_build admits none.
__device__ __forceinline__ bool safety_warp(const St& st, int code,
                                            unsigned long long& P,
                                            bool& have_p, int lane) {
  const int N = st.d.N;
  switch (code) {
    case PRED_MESSAGES:
      return messages_inv_warp(st, lane);
    case PRED_LEADER_VOTES_QUORUM:
      return leader_votes_quorum_warp(st, lane);
    case PRED_CANDIDATE_TERM_NOT_IN_LOG:
      return candidate_term_not_in_log_warp(st, lane);
    case PRED_ELECTION_SAFETY:
    case PRED_LOG_MATCHING:
    case PRED_VOTES_GRANTED:
    case PRED_QUORUM_LOG:
    case PRED_MORE_UP_TO_DATE:
    case PRED_LEADER_COMPLETENESS:
      break;
    default:
      return false;
  }
  if (code >= PRED_VOTES_GRANTED && !have_p) {
    P = committed_prefix_warp(st, lane);
    have_p = true;
  }
  if (code == PRED_QUORUM_LOG) {  // 2 * |bad| <= N for every i
    const unsigned long long row = (1ull << N) - 1;
    bool ok = true;
    for (int i = 0; i < N; ++i)
      ok &= 2 * (N - __popcll((P >> (i * N)) & row)) <= N;
    return ok;
  }
  bool ok = true;
  for (int p = lane; p < N * N; p += 32)
    ok &= pair_ok(st, code, p / N, p % N, P);
  return __all_sync(kFull, ok);
}

// The index in the run's list of the first predicate that fails on one
// state, -1 where all hold, by a whole warp.  `list` holds `n` codes of 4
// bits, the first in the low bits.  kSuite = false is the build for lists
// of TypeOK and NoLeaderElected only (chunk_front_build picks it), which
// keeps the suite's code out of that build; kReconfig widens TypeOK, and
// the suite reads the variant's decoded values whole (see the header).
template <bool kSuite, bool kReconfig = false>
__device__ __forceinline__ int first_failing_warp(const St& st,
                                                  unsigned long long list,
                                                  int n, int lane) {
  unsigned long long P = 0;
  bool have_p = false;
  for (int p = 0; p < n; ++p) {
    const int code = (int)((list >> (4 * p)) & 15ull);
    bool holds;
    switch (code) {
      case PRED_TYPE_OK:
        holds = type_ok_warp<kReconfig>(st, lane);
        break;
      case PRED_NO_LEADER:
        holds = no_leader_warp(st, lane);
        break;
      default:
        if constexpr (kSuite)
          holds = safety_warp(st, code, P, have_p, lane);
        else
          holds = false;
    }
    if (!holds) return p;
  }
  return -1;
}

// BoundedSpace: each bound is INT_MAX when the cfg does not set it.
struct Bounds {
  int max_term, max_log_len, max_msg_count, max_in_flight;
};

__device__ __forceinline__ bool bounded_space_warp(const St& st,
                                                   const Bounds& b,
                                                   int lane) {
  bool ok = true;
  for (int i = lane; i < st.d.N; i += 32)
    ok &= st.term(i) <= b.max_term && st.ll(i) <= b.max_log_len;
  int in_flight = 0;
  for (int base = 0; base < st.d.M; base += 32) {
    const int s = base + lane;
    const bool live = s < st.d.M;
    if (live) ok &= st.cnt(s) <= b.max_msg_count;
    in_flight += __popc(__ballot_sync(0xffffffffu, live && st.cnt(s) > 0));
  }
  return __all_sync(0xffffffffu, ok) && in_flight <= b.max_in_flight;
}

}  // namespace rtt
