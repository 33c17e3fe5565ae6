// The v4 chunk front: masks -> POR -> compaction -> delta fingerprints,
// successor rows, constraint, invariant id and parent fingerprints.
//
// Replaces raft_tla_tpu/ops/chunk_front_pallas.py `_front_kernel` (built by
// `build_front`), which loads the B-row parent window into VMEM once and
// replays the traced model in one grid-less program, with a sequential
// `fori_loop` for the compaction.  On Hopper the three stages become three
// launches on one stream, with no host round trip between them:
//
//   1. masks_kernel: one warp per parent row.  The row is decoded into ints
//      in shared memory; lanes take the G instances in strides of 32
//      (raft_model.cuh `guard`), the POR step keeps the lowest-priority
//      certified enabled lane per row (lowest g on ties, as jnp.argmin), and
//      the warp writes en/ovf/pruned [B, G], the row's fan-out (its final
//      en bits) into counts[B], and the row's hash sums (ordered-part base,
//      bag sum, per-slot hashes, parent fingerprint) into a [B, 6 + 2M]
//      scratch.
//   2. compact_scan_kernel: B3's multi-block scan and write (compact.cuh),
//      16 rows a block, each block clearing its own rows >= P in en/ovf.
//   3. lanes_kernel: a block of 8 warps takes a run of kRun = 64
//      consecutive compacted lanes (lane < total).  Compacted lanes come in
//      ascending flat order, so a run spans a handful of parents (about 16
//      lanes a parent on the main path): the block lists the run's distinct
//      parents and decodes EACH ONCE into shared memory (up to kCap at a
//      time; a run with more, as under POR, takes several rounds).  Then a
//      THREAD PER LANE does `lane_out`'s scalar work once (instance decode,
//      receive_ctx, the AdvanceCommitIndex quorum, the message row, the
//      send's equal-row and free-slot search), writes the lane's ordered
//      edit list (position, value) into shared memory, summing each
//      ordered-part edit's fingerprint delta against the value the position
//      holds just before it, and writes the fingerprints.  Then the warps
//      materialise the successors, a warp a lane: the parent's ints with
//      the edits overlaid (the last edit of a position wins, which is the
//      in-order result), the constraint and the invariants on those ints,
//      and the row as bytes (ints wrap mod 256 only here), stored as
//      16-byte words with the unaligned head and tail as bytes.  The
//      invariants are the run's list of predicate codes, evaluated in
//      order until one fails (raft_model.cuh `first_failing_warp`); a
//      list that names one of the nine safety predicates takes the
//      launch's second build (kSuite), so the TypeOK-only build carries
//      none of their code.
//
// The joint-consensus reconfiguration variant (models/reconfig.py) has
// builds of its own of the masks and lanes launches (kReconfig): 12
// families (the targets ride in Dims), the config scan and the joint
// quorum, the two appends (three ordered positions each), rows with the
// value high-byte planes, the widened TypeOK.  Those builds take TypeOK,
// NoLeaderElected and BoundedSpace; a list with a safety predicate is
// refused for the variant (cudaErrorInvalidValue, and ValueError in the
// wrapper when the front is built).
//
// Dead compacted lanes (lane >= total) are left unwritten in kh, kl, krows,
// cons_ok, inv, parent_hi and parent_lo: nothing downstream reads them (the
// fused tail reads only enqueued lanes; violations and trace links go
// through is_new, which is false there).
//
// Bound on the H100: bytes.  The function reads the B parent rows and
// writes the three [B, G] masks, lane_id/kvalid, and each live lane's row
// and scalars: about 19 MB for a full main-path window (B=2048, K=32768,
// ~32,700 live lanes), under 6 us at 3.35 TB/s.  What is left: the guards
// still loop over the message slots per instance in the masks launch, the
// scalar phase runs 64 threads of a block's 256 with the ten families
// diverging, and the three launches could become two (the scan folded into
// the lanes launch).  chip_smoke.py times each launch.

#include <climits>

#include "compact.cuh"
#include "raft_model.cuh"

namespace {

using rtt::Dims;
using rtt::St;

constexpr int kWarps = 8;  // warps (rows or lanes) per block
constexpr int kThreads = kWarps * 32;
constexpr int kScr = 6;    // scratch row: base0 base1 msum0 msum1 phi plo

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int masks_warp_bytes(const Dims& d) {
  return align16(d.sw * 4) + align16(2 * d.G);
}

template <bool kReconfig>
__global__ void __launch_bounds__(kThreads)
masks_kernel(Dims d, const uint8_t* __restrict__ rows,
             const uint8_t* __restrict__ valid, int B,
             const uint8_t* __restrict__ por_mask,
             const int32_t* __restrict__ por_pri,
             const uint32_t* __restrict__ salts, uint8_t* __restrict__ en_out,
             uint8_t* __restrict__ ovf_out, uint8_t* __restrict__ pruned_out,
             int32_t* __restrict__ counts, uint32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  uint8_t* mine = smem + (size_t)warp * masks_warp_bytes(d);
  int* sv = reinterpret_cast<int*>(mine);
  uint8_t* en_s = mine + align16(d.sw * 4);
  uint8_t* ovf_s = en_s + d.G;
  rtt::decode_row<kReconfig>(d, rows + (size_t)b * d.sw, sv, lane);
  __syncwarp();
  const St st{d, sv};
  const bool ok_row = valid[b] != 0;

  // Guards, with the valid mask applied; the POR argmin rides along.
  // (priority biased to unsigned, g): the lowest key wins.
  unsigned long long best = ~0ull;
  bool any_amp = false;
  for (int g = lane; g < d.G; g += 32) {
    bool en, ovf;
    rtt::guard<kReconfig>(st, g, &en, &ovf);
    en &= ok_row;
    ovf &= ok_row;
    en_s[g] = en;
    ovf_s[g] = ovf;
    if (por_mask) {
      const bool amp = en && por_mask[g];
      any_amp |= amp;
      const int pri = amp ? por_pri[g] : INT_MAX;
      const unsigned long long key =
          ((unsigned long long)((uint32_t)pri ^ 0x80000000u) << 32) |
          (uint32_t)g;
      best = key < best ? key : best;
    }
  }
  int sel = -1;
  if (por_mask) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long other =
          __shfl_xor_sync(0xffffffffu, best, o);
      best = other < best ? other : best;
    }
    any_amp = __any_sync(0xffffffffu, any_amp);
    if (any_amp) sel = (int)(uint32_t)best;
  }
  __syncwarp();
  uint8_t* en_row = en_out + (size_t)b * d.G;
  uint8_t* ovf_row = ovf_out + (size_t)b * d.G;
  uint8_t* pr_row = pruned_out + (size_t)b * d.G;
  int fan = 0;
  for (int g = lane; g < d.G; g += 32) {
    const bool keep = sel < 0 || g == sel;
    const bool en = en_s[g];
    en_row[g] = en && keep;
    ovf_row[g] = ovf_s[g] && keep;
    pr_row[g] = en && !keep;
    fan += en && keep;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) fan += __shfl_xor_sync(0xffffffffu, fan, o);
  if (lane == 0) counts[b] = fan;

  // Parent hash sums (parent_hash) and fingerprint (parent_fp).
  const rtt::Salts k{salts, d.D, d.W};
  uint32_t base0 = 0, base1 = 0, msum0 = 0, msum1 = 0;
  for (int p = lane; p < d.D; p += 32) {
    base0 += rtt::contrib(k, 0, p, sv[p]);
    base1 += rtt::contrib(k, 1, p, sv[p]);
  }
  uint32_t* scr = scratch + (size_t)b * (kScr + 2 * d.M);
  for (int s = lane; s < d.M; s += 32) {
    const uint32_t h0 = rtt::slot_hash(k, 0, st, s);
    const uint32_t h1 = rtt::slot_hash(k, 1, st, s);
    scr[kScr + s] = h0;
    scr[kScr + d.M + s] = h1;
    if (st.cnt(s) > 0) {
      msum0 += h0 * (uint32_t)st.cnt(s);
      msum1 += h1 * (uint32_t)st.cnt(s);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    base0 += __shfl_xor_sync(0xffffffffu, base0, o);
    base1 += __shfl_xor_sync(0xffffffffu, base1, o);
    msum0 += __shfl_xor_sync(0xffffffffu, msum0, o);
    msum1 += __shfl_xor_sync(0xffffffffu, msum1, o);
  }
  if (lane == 0) {
    const uint32_t hi = rtt::finalize(base0, msum0, k.seed(0));
    const uint32_t lo = rtt::finalize(base1, msum1, k.seed(1));
    scr[0] = base0;
    scr[1] = base1;
    scr[2] = msum0;
    scr[3] = msum1;
    scr[4] = hi;
    scr[5] = rtt::remap_sentinel(hi, lo);
  }
}

constexpr int kRun = 64;  // compacted lanes a lanes block takes
constexpr int kCap = 8;   // parent rows it holds decoded at once
constexpr int kMeta = 9;  // per-lane and per-parent int arrays, kRun each

// (position, value) edits one lane can make (lane_out): 11 + 2N
// ordered-part positions and two message counts.  The bag's rows change
// by row operations (Edits below), not by edits.
__host__ __device__ inline int max_edits(const Dims& d) {
  return 13 + 2 * d.N;
}

// The lanes launch's dynamic shared memory (all of it; the kernel has no
// static shared memory), in this order: kCap decoded parents, a decoded
// successor and a byte row a warp, each lane's edit values, positions and
// message row, the kMeta arrays, the block scan's 32 ints and 16 family
// counts.  ops/chunk_front_cuda.py `lanes_smem` computes the same total.
struct LanesSmem {
  int row_ints, stage_bytes, E;
  int stg, bst, val, pos, msg, meta, bytes;
};

__host__ __device__ inline LanesSmem lanes_smem(const Dims& d) {
  LanesSmem s;
  s.row_ints = align16(d.sw * 4) / 4;
  s.stage_bytes = align16(d.sw + 16);
  s.E = max_edits(d);
  s.stg = kCap * s.row_ints * 4;
  s.bst = s.stg + kWarps * s.row_ints * 4;
  s.val = s.bst + kWarps * s.stage_bytes;
  s.pos = s.val + align16(kRun * s.E * 4);
  s.msg = s.pos + align16(kRun * s.E * 2);
  s.meta = s.msg + align16(kRun * d.W * 4);
  s.bytes = s.meta + (kMeta * kRun + 32 + 16) * 4;
  return s;
}

struct LaneOut {
  int64_t* kh;
  int64_t* kl;
  uint8_t* krows;
  uint8_t* cons;
  int64_t* inv;
  int64_t* phi;
  int64_t* plo;
};

// One lane's edits over its parent's decoded ints: the ordered-part and
// count positions as an ordered (position, value) list, and the bag's rows
// as two row operations applied in this order: slot `clr` zeroed (a
// discard that empties it), then slot `wr` set to the message row `m` (a
// send of a new row, which may reuse that slot).  The list and the rows
// touch disjoint positions, so the two kinds commute.
struct Edits {
  const int* par;
  int16_t* pos;
  int* val;
  int* m;  // W ints
  int n, clr, wr;
  // The value `p` holds after the list's edits so far.
  __device__ int cur(int p) const {
    for (int e = n - 1; e >= 0; --e)
      if (pos[e] == p) return val[e];
    return par[p];
  }
  __device__ void set(int p, int v) {
    pos[n] = (int16_t)p;
    val[n] = v;
    ++n;
  }
};

// lane_out's scalars for compacted lane q (instance g of the parent `st`),
// by one thread: the edit list into `ed`, the fingerprints and the parent
// fingerprint into `out`.
template <bool kReconfig>
__device__ void lane_edits(const Dims& d, const rtt::Salts& k,
                           const St& st, int g,
                           const uint32_t* __restrict__ scr, Edits& ed,
                           const LaneOut& out, int q) {
  const int N = d.N, L = d.L, M = d.M;
  const rtt::Inst in = rtt::decode_instance<kReconfig>(d, g);
  const int fam = in.fam;
  if constexpr (kReconfig) {
    if (fam >= rtt::kNFam) {
      // InitiateReconfig / FinalizeReconfig: (term[i], val) appended at
      // (i, Len(log[i])), three ordered positions; the bag is untouched.
      const int i = in.p1, ln = st.ll(i);
      const int kp = rtt::clampi(ln, 0, L - 1);
      int val;
      rtt::reconfig_guard(st, in, &val);
      uint32_t db0 = 0, db1 = 0;
      auto put = [&](int pos, int v) {
        const int old = ed.cur(pos);
        db0 += rtt::contrib(k, 0, pos, v) - rtt::contrib(k, 0, pos, old);
        db1 += rtt::contrib(k, 1, pos, v) - rtt::contrib(k, 1, pos, old);
        ed.set(pos, v);
      };
      put(d.o_lt + i * L + kp, st.term(i));
      put(d.o_lv + i * L + kp, val);
      put(d.o_ll + i, ln + 1);
      const uint32_t hi = rtt::finalize(scr[0] + db0, scr[2], k.seed(0));
      const uint32_t lo = rtt::finalize(scr[1] + db1, scr[3], k.seed(1));
      out.kh[q] = hi;
      out.kl[q] = rtt::remap_sentinel(hi, lo);
      out.phi[q] = scr[4];
      out.plo[q] = scr[5];
      return;
    }
  }
  // Reads clamp, as JAX gathers do: a slot family's p1 is a slot index,
  // read as a server only under gates that are off for it.
  const int i = rtt::clampi(in.p1, 0, N - 1);
  const int jv = in.p2;
  const int s = in.p1;
  const int s_rd = rtt::clampi(s, 0, M - 1);
  const bool is_restart = fam == 0, is_timeout = fam == 1, is_rv = fam == 2,
             is_bl = fam == 3, is_cr = fam == 4, is_ac = fam == 5,
             is_ae = fam == 6, is_recv = fam == 7, is_dup = fam == 8,
             is_drop = fam == 9;
  // Receive's context; every use of it below is gated on is_recv (zeros,
  // all guards off, for the other families).
  const rtt::Recv rc = is_recv ? rtt::receive_ctx(st, s_rd) : rtt::Recv{};
  const int term_i = st.term(i), ln_i = st.ll(i), ri = rc.i, rj = rc.j;

  const bool ut_fire = is_recv && rc.en_ut;
  const bool term_wr = is_timeout || ut_fire;
  const int term_tgt = is_timeout ? i : ri;
  const int term_new = is_timeout ? term_i + 1 : rc.mterm;

  const bool role_wr = is_restart || is_timeout || is_bl ||
                       (is_recv && (rc.en_ut || rc.en_rtf));
  const int role_tgt = is_recv ? ri : i;
  const int role_new = is_restart ? rtt::FOLLOWER
                       : is_timeout ? rtt::CANDIDATE
                       : is_bl      ? rtt::LEADER
                                    : rtt::FOLLOWER;

  const bool grant_fire = is_recv && rc.en_rvq && rc.grant;
  const bool voted_wr = is_timeout || ut_fire || grant_fire;
  const int voted_tgt = is_timeout ? i : ri;
  const int voted_new = grant_fire ? rj + 1 : rtt::NIL;

  const bool conf_fire = is_recv && rc.en_conf;
  const bool noc_fire = is_recv && rc.en_noc;
  const bool log_wr = is_cr || conf_fire || noc_fire;
  const int log_tgt = is_cr ? i : ri;
  const int log_k = is_cr       ? rtt::clampi(ln_i, 0, L - 1)
                    : conf_fire ? rtt::clampi(rc.ln - 1, 0, L - 1)
                                : rtt::clampi(rc.ln, 0, L - 1);
  const int log_t_new = is_cr ? term_i : (conf_fire ? 0 : rc.eterm);
  const int log_v_new = is_cr ? jv : (conf_fire ? 0 : rc.evalue);
  const int ll_new = conf_fire ? rc.ln - 1 : (is_cr ? ln_i + 1 : rc.ln + 1);

  // AdvanceCommitIndex: the largest index a quorum (with i itself) agrees
  // on, if it lies in i's log and carries i's current term.
  int ac_commit = st.ci(i);
  if (is_ac) {
    int max_agree = 0;
    for (int idx = 1; idx <= L; ++idx) {
      if constexpr (kReconfig) {
        int member = 0;
        for (int n = 0; n < N; ++n)
          member |= (st.mi(i, n) >= idx || n == i) << n;
        if (rtt::quorum<true>(st, i, member) && idx <= ln_i) max_agree = idx;
      } else {
        int member = 0;
        for (int n = 0; n < N; ++n) member += st.mi(i, n) >= idx || n == i;
        if (2 * member > N && idx <= ln_i) max_agree = idx;
      }
    }
    const bool own_term =
        st.lt(i, rtt::clampi(max_agree - 1, 0, L - 1)) == term_i;
    if (max_agree > 0 && own_term) ac_commit = max_agree;
  }
  const bool done_fire = is_recv && rc.en_done;
  const bool commit_wr = is_restart || is_ac || done_fire;
  const int commit_tgt = is_recv ? ri : i;
  const int commit_new = is_restart ? 0 : (is_ac ? ac_commit : rc.mcommit);

  const bool rvr_fire = is_recv && rc.en_rvr;
  const bool votes_wr = is_restart || is_timeout || rvr_fire;
  const int vr_tgt = is_recv ? ri : i;
  const int vr_new = rvr_fire ? (st.vr(ri) | (1 << rj)) : 0;
  const int vg_new =
      rvr_fire ? (st.vg(ri) | ((rc.m4 > 0 ? 1 : 0) << rj)) : 0;

  const bool rows_wr = is_restart || is_bl;
  const int ni_row_new = is_restart ? 1 : ln_i + 1;
  const bool aer_fire = is_recv && rc.en_aer;
  const bool succ_flag = rc.m4 > 0;
  const int ni_rr = st.ni(ri, rj), mi_rr = st.mi(ri, rj);
  const int ni_cell_new = succ_flag ? rc.m5 + 1 : max(ni_rr - 1, 1);
  const int mi_cell_new = succ_flag ? rc.m5 : mi_rr;

  // The ordered part's edits, each with its fingerprint delta against the
  // value the position holds just before it.
  uint32_t db0 = 0, db1 = 0;
  auto put = [&](int pos, int v) {
    const int old = ed.cur(pos);
    db0 += rtt::contrib(k, 0, pos, v) - rtt::contrib(k, 0, pos, old);
    db1 += rtt::contrib(k, 1, pos, v) - rtt::contrib(k, 1, pos, old);
    ed.set(pos, v);
  };
  if (term_wr) put(d.o_term + term_tgt, term_new);
  if (role_wr) put(d.o_role + role_tgt, role_new);
  if (voted_wr) put(d.o_voted + voted_tgt, voted_new);
  if (log_wr) {
    put(d.o_lt + log_tgt * L + log_k, log_t_new);
    put(d.o_lv + log_tgt * L + log_k, log_v_new);
    put(d.o_ll + log_tgt, ll_new);
  }
  if (commit_wr) put(d.o_ci + commit_tgt, commit_new);
  if (votes_wr) {
    put(d.o_vr + vr_tgt, vr_new);
    put(d.o_vg + vr_tgt, vg_new);
  }
  if (rows_wr) {
    for (int n = 0; n < N; ++n) {
      put(d.o_ni + i * N + n, ni_row_new);
      put(d.o_mi + i * N + n, 0);
    }
  }
  if (aer_fire) {
    put(d.o_ni + ri * N + rj, ni_cell_new);
    put(d.o_mi + ri * N + rj, mi_cell_new);
  }

  // The bag: discard (its slot cleared when its count reaches 0) before
  // the send, which may reuse that slot; duplicate.  msum's delta comes
  // from the parent's slot hashes, as lane_out computes it.
  const bool rvq_fire = is_recv && rc.en_rvq;
  const bool rej_fire = is_recv && rc.en_rej;
  const bool reply_fire = rvq_fire || rej_fire || done_fire;
  const bool disc_only = is_recv && (rc.en_rvr_drop || rc.en_rvr ||
                                     rc.en_aer_drop || rc.en_aer);
  const bool do_discard = reply_fire || disc_only || is_drop;
  const bool do_send = is_rv || is_ae || reply_fire;
  const uint32_t sh_s0 = scr[kScr + s_rd], sh_s1 = scr[kScr + M + s_rd];
  uint32_t dm0 = 0, dm1 = 0;
  if (do_discard) {
    const int c = ed.cur(d.o_cnt + s) - 1;
    ed.set(d.o_cnt + s, c);
    if (c <= 0) ed.clr = s;
    dm0 -= sh_s0;
    dm1 -= sh_s1;
  }
  if (do_send) {
    int* m = ed.m;
    if (is_rv)
      rtt::rv_msg(st, i, jv, m);
    else if (is_ae)  // AE reads clamp, as JAX gathers do
      rtt::ae_msg(st, i, rtt::clampi(jv, 0, N - 1), m);
    else
      rtt::reply_row(st, rc, rvq_fire, rej_fire, m);
    const rtt::Send sc =
        rtt::send_ctx(st, m, s, reply_fire && rc.cnt_s == 1);
    if (sc.ok) {
      if (sc.has_eq) {
        dm0 += scr[kScr + sc.idx];
        dm1 += scr[kScr + M + sc.idx];
      } else {
        ed.wr = sc.idx;
        dm0 += rtt::row_hash(k, 0, m, d.W);
        dm1 += rtt::row_hash(k, 1, m, d.W);
      }
      ed.set(d.o_cnt + sc.idx, ed.cur(d.o_cnt + sc.idx) + 1);
    }
  }
  if (is_dup) {
    ed.set(d.o_cnt + s, ed.cur(d.o_cnt + s) + 1);
    dm0 += sh_s0;
    dm1 += sh_s1;
  }
  const uint32_t hi = rtt::finalize(scr[0] + db0, scr[2] + dm0, k.seed(0));
  const uint32_t lo = rtt::finalize(scr[1] + db1, scr[3] + dm1, k.seed(1));
  out.kh[q] = hi;
  out.kl[q] = rtt::remap_sentinel(hi, lo);
  out.phi[q] = scr[4];
  out.plo[q] = scr[5];
}

// The high byte of value `v` written at base position p into its plane
// (the decoded ints and the staged bytes), where p holds a value.
__device__ __forceinline__ void put_hi(const Dims& d, int* sv, uint8_t* bo,
                                       int p, int v) {
  const int h = rtt::value_hi(d, p);
  if (h >= 0) {
    sv[h] = (v >> 8) & 0xFF;
    bo[h] = (uint8_t)(v >> 8);
  }
}

// Compacted lane q's successor, by one warp: the parent's ints `pv` with
// the lane's edits `ed` applied into `sv`, the constraint and the
// invariants (`n_inv` codes of 4 bits in `inv_list`) on them, and the row
// as bytes through the warp's staging row `bs`.  kReconfig writes each
// value's high byte into its plane beside it.
template <bool kSuite, bool kReconfig>
__device__ __forceinline__ void successor(
    const Dims& d, const int* pv, const Edits& ed, int* sv, uint8_t* bs,
    int row_ints, const rtt::Bounds& bounds, unsigned long long inv_list,
    int n_inv, const LaneOut& out, int q, int lane) {
  // Row q sits at any byte offset: its bytes are staged in `bs` at the
  // same offset mod 16, beside the ints (copied 16 bytes a lane).
  uint8_t* row = out.krows + (size_t)q * d.sw;
  const int off = (int)((uintptr_t)row & 15);
  uint8_t* bo = bs + off;
  for (int w = lane; 4 * w < d.sw; w += 32) {
    const int4 v = reinterpret_cast<const int4*>(pv)[w];
    reinterpret_cast<int4*>(sv)[w] = v;
    const int p = 4 * w;
    bo[p] = (uint8_t)v.x;
    if (p + 1 < d.sw) bo[p + 1] = (uint8_t)v.y;
    if (p + 2 < d.sw) bo[p + 2] = (uint8_t)v.z;
    if (p + 3 < d.sw) bo[p + 3] = (uint8_t)v.w;
  }
  __syncwarp();
  // The list: the last edit of each position is its in-order result.
  for (int e = lane; e < ed.n; e += 32) {
    const int p = ed.pos[e];
    bool last = true;
    for (int f = e + 1; f < ed.n && last; ++f) last = ed.pos[f] != p;
    if (last) {
      sv[p] = ed.val[e];
      bo[p] = (uint8_t)(ed.val[e] & 0xFF);
      if constexpr (kReconfig) put_hi(d, sv, bo, p, ed.val[e]);
    }
  }
  // The bag's rows: the clear, then the new row.
  if (ed.clr >= 0)
    for (int c = lane; c < d.W; c += 32) {
      const int p = d.o_msg + ed.clr * d.W + c;
      sv[p] = 0;
      bo[p] = 0;
      if constexpr (kReconfig) put_hi(d, sv, bo, p, 0);
    }
  __syncwarp();
  if (ed.wr >= 0)
    for (int c = lane; c < d.W; c += 32) {
      const int p = d.o_msg + ed.wr * d.W + c;
      sv[p] = ed.m[c];
      bo[p] = (uint8_t)(ed.m[c] & 0xFF);
      if constexpr (kReconfig) put_hi(d, sv, bo, p, ed.m[c]);
    }
  __syncwarp();
  const St st{d, sv};
  const bool cons = rtt::bounded_space_warp(st, bounds, lane);
  const int inv =
      rtt::first_failing_warp<kSuite, kReconfig>(st, inv_list, n_inv, lane);
  // The whole 16-byte words of the destination as uint4, its head and
  // tail as bytes.
  uint8_t* base = row - off;
  const int end = off + d.sw;
  const int c_lo = (off + 15) >> 4, c_hi = end >> 4;
  for (int c = c_lo + lane; c < c_hi; c += 32)
    *reinterpret_cast<uint4*>(base + 16 * c) =
        *reinterpret_cast<const uint4*>(bs + 16 * c);
  const int head_end = min(16 * c_lo, end);
  for (int p = off + lane; p < head_end; p += 32) base[p] = bs[p];
  for (int p = max(16 * c_hi, head_end) + lane; p < end; p += 32)
    base[p] = bs[p];
  if (lane == 0) {
    out.cons[q] = cons;
    out.inv[q] = inv;
  }
  __syncwarp();
}

// At least 4 blocks an SM (64 registers a thread): the scalar and the
// successor phases of one block overlap those of the others.  kSuite
// builds the safety suite's predicates in (raft_model.cuh
// `first_failing_warp`); the launcher takes that build only for a list
// that names one of them.
template <bool kSuite, bool kReconfig>
__global__ void __launch_bounds__(kThreads, 4)
lanes_kernel(Dims d, const uint8_t* __restrict__ rows,
             const int32_t* __restrict__ pt,
             const int32_t* __restrict__ lane_id,
             const uint32_t* __restrict__ scratch,
             const uint32_t* __restrict__ salts, rtt::Bounds bounds,
             unsigned long long inv_list, int n_inv, LaneOut out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const LanesSmem S = lanes_smem(d);
  int* par = reinterpret_cast<int*>(smem);
  int* stg = reinterpret_cast<int*>(smem + S.stg);
  uint8_t* bst = smem + S.bst;
  int* ed_val = reinterpret_cast<int*>(smem + S.val);
  int16_t* ed_pos = reinterpret_cast<int16_t*>(smem + S.pos);
  int* ed_msg = reinterpret_cast<int*>(smem + S.msg);
  int* n_ed = reinterpret_cast<int*>(smem + S.meta);
  int* clr = n_ed + kRun;  // lane -> its row operations
  int* wr = clr + kRun;
  int* lb = wr + kRun;    // lane -> parent row
  int* lg = lb + kRun;    // lane -> instance
  int* ps = lg + kRun;    // lane -> parent slot in the run
  int* pb = ps + kRun;    // parent slot -> row
  int* pf = pb + kRun;    // parent slot -> its first lane
  int* order = pf + kRun; // the run's lanes by family
  int* scan = order + kRun;
  int* fam_n = scan + 32;
  const int total = pt[1];
  const int q0 = blockIdx.x * kRun;
  if (q0 >= total) return;
  const int nl = min(kRun, total - q0);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  // 1. The run's lanes, its distinct parents in ascending order, and the
  //    lanes by family (the order the scalar phase's threads take them
  //    in, so a warp's threads mostly share their family's path; any
  //    order gives the same outputs).
  int fam = 0;
  if (t < nl) {
    const int lid = lane_id[q0 + t];
    const int b = lid / d.G;
    lb[t] = b;
    lg[t] = lid - b * d.G;
    fam = rtt::decode_instance<kReconfig>(d, lg[t]).fam;
  }
  if (t < 16) fam_n[t] = 0;
  __syncthreads();
  const int head = t < nl && (t == 0 || lb[t - 1] != lb[t]) ? 1 : 0;
  int np;
  const int slot = rtt::block_exclusive_scan(head, &np, scan);
  if (head) {
    pb[slot] = lb[t];
    pf[slot] = t;
  }
  int rank = 0;
  if (t < nl) {
    ps[t] = slot + head - 1;
    rank = atomicAdd(&fam_n[fam], 1);
  }
  __syncthreads();
  if (t == 0)
    for (int f = 0, acc = 0; f < (kReconfig ? rtt::kMaxFam : rtt::kNFam);
         ++f) {
      const int c = fam_n[f];
      fam_n[f] = acc;
      acc += c;
    }
  __syncthreads();
  if (t < nl) order[fam_n[fam] + rank] = t;
  __syncthreads();

  // 2. Rounds of up to kCap parents: decode each once, a thread per lane
  //    for the scalars, a warp per lane for the successor.
  const rtt::Salts k{salts, d.D, d.W};
  for (int p0 = 0; p0 < np; p0 += kCap) {
    const int pn = min(kCap, np - p0);
    for (int w = warp; w < pn; w += kWarps)
      rtt::decode_row<kReconfig>(d, rows + (size_t)pb[p0 + w] * d.sw,
                                 par + w * S.row_ints, lane);
    __syncthreads();
    const int t_lo = pf[p0], t_hi = p0 + pn < np ? pf[p0 + pn] : nl;
    const int l = t < nl ? order[t] : -1;
    if (l >= t_lo && l < t_hi) {
      const int* pv = par + (ps[l] - p0) * S.row_ints;
      Edits ed{pv, ed_pos + l * S.E, ed_val + l * S.E, ed_msg + l * d.W,
               0, -1, -1};
      lane_edits<kReconfig>(d, k, St{d, pv}, lg[l],
                 scratch + (size_t)lb[l] * (kScr + 2 * d.M), ed, out,
                 q0 + l);
      n_ed[l] = ed.n;
      clr[l] = ed.clr;
      wr[l] = ed.wr;
    }
    __syncthreads();
    for (int r = t_lo + warp; r < t_hi; r += kWarps) {
      const int* pv = par + (ps[r] - p0) * S.row_ints;
      const Edits ed{pv, ed_pos + r * S.E, ed_val + r * S.E,
                     ed_msg + r * d.W, n_ed[r], clr[r], wr[r]};
      successor<kSuite, kReconfig>(d, pv, ed, stg + warp * S.row_ints,
                        bst + warp * S.stage_bytes, S.row_ints, bounds,
                        inv_list, n_inv, out, q0 + r, lane);
    }
    __syncthreads();
  }
}

int masks_blocks(int B) { return (B + kWarps - 1) / kWarps; }
int lanes_blocks(int K) { return (K + kRun - 1) / kRun; }

// The invariant list as the lanes launch takes it: the codes 4 bits each,
// the first in the low bits, and whether one of them is the suite's.
// cudaErrorInvalidValue for a list longer than kMaxInv or a code the
// kernel has no device code for.
int pack_invariants(const int* codes, int n, unsigned long long* list,
                    bool* suite) {
  if (n < 0 || n > rtt::kMaxInv || (n > 0 && codes == nullptr))
    return (int)cudaErrorInvalidValue;
  *list = 0;
  *suite = false;
  for (int p = 0; p < n; ++p) {
    if (codes[p] < 1 || codes[p] > rtt::kNumPred)
      return (int)cudaErrorInvalidValue;
    *list |= (unsigned long long)codes[p] << (4 * p);
    *suite |= codes[p] > rtt::PRED_NO_LEADER;
  }
  return 0;
}

// Dims this kernel takes: the static maxima, and for the reconfig variant
// (T > 0) at most 7 servers and kMaxTargets targets.
bool dims_ok(int N, int V, int L, int M, int T) {
  return N >= 1 && N <= rtt::kMaxN && L >= 1 && L <= rtt::kMaxL && M >= 1 &&
         M <= rtt::kMaxM && V >= 1 && T >= 0 && T <= rtt::kMaxTargets &&
         (T == 0 || N <= 7);
}

}  // namespace

// One front call: three launches on `stream`.  `inv_codes` is a host
// array of `n_inv` predicate codes in the run's order; `targets` a host
// array of the reconfig variant's `n_targets` target configs (0 for the
// spec).  Returns a cudaError_t (cudaErrorInvalidValue for dims or
// predicates this kernel does not take).
extern "C" int chunk_front_launch(
    int N, int V, int L, int M, const int* targets, int n_targets,
    const void* rows, const void* valid, int B, int K, const void* kspread,
    const void* por_mask, const void* por_pri, const void* salts,
    const int* inv_codes, int n_inv, int max_term, int max_log_len,
    int max_msg_count, int max_in_flight, void* scratch, void* counts,
    void* en, void* ovf, void* pruned, void* pt, void* lane_id, void* kvalid,
    void* kh, void* kl, void* krows, void* cons, void* inv, void* phi,
    void* plo, void* stream) {
  if (!dims_ok(N, V, L, M, n_targets) || B < 1 ||
      (n_targets > 0 && targets == nullptr))
    return (int)cudaErrorInvalidValue;
  unsigned long long inv_list;
  bool suite;
  int e;
  if ((e = pack_invariants(inv_codes, n_inv, &inv_list, &suite))) return e;
  const bool reconfig = n_targets > 0;
  if (reconfig && suite) return (int)cudaErrorInvalidValue;
  const Dims d = rtt::make_dims(N, V, L, M, n_targets, targets);
  cudaStream_t st = (cudaStream_t)stream;

  const size_t smem_a = (size_t)kWarps * masks_warp_bytes(d);
  auto masks = reconfig ? masks_kernel<true> : masks_kernel<false>;
  if ((e = rtt::allow_smem(masks, smem_a))) return e;
  masks<<<masks_blocks(B), kThreads, smem_a, st>>>(
      d, (const uint8_t*)rows, (const uint8_t*)valid, B,
      (const uint8_t*)por_mask, (const int32_t*)por_pri,
      (const uint32_t*)salts, (uint8_t*)en, (uint8_t*)ovf, (uint8_t*)pruned,
      (int32_t*)counts, (uint32_t*)scratch);
  if ((e = (int)cudaGetLastError())) return e;

  rtt::compact_scan_kernel<<<rtt::scan_blocks(B), rtt::kScanThreads, 0,
                             st>>>(
      (const uint8_t*)en, (const int32_t*)counts, B, d.G, K,
      (const int32_t*)kspread, (int32_t*)pt, (int32_t*)lane_id,
      (uint8_t*)kvalid, (uint8_t*)en, (uint8_t*)ovf);
  if ((e = (int)cudaGetLastError())) return e;

  const size_t smem_c = lanes_smem(d).bytes;
  auto lanes = reconfig ? lanes_kernel<false, true>
               : suite  ? lanes_kernel<true, false>
                        : lanes_kernel<false, false>;
  if ((e = rtt::allow_smem(lanes, smem_c))) return e;
  const rtt::Bounds bounds{max_term, max_log_len, max_msg_count,
                           max_in_flight};
  const LaneOut out{(int64_t*)kh,  (int64_t*)kl,  (uint8_t*)krows,
                    (uint8_t*)cons, (int64_t*)inv, (int64_t*)phi,
                    (int64_t*)plo};
  lanes<<<lanes_blocks(K), kThreads, smem_c, st>>>(
      d, (const uint8_t*)rows, (const int32_t*)pt, (const int32_t*)lane_id,
      (const uint32_t*)scratch, (const uint32_t*)salts, bounds, inv_list,
      n_inv, out);
  return (int)cudaGetLastError();
}

namespace {

// The builds of one call, for chip_smoke.py: 0 masks, 1 compaction, 2
// lanes, 3 lanes with the safety suite, 4 masks of the reconfig variant,
// 5 lanes of the reconfig variant.
template <typename F>
int with_build(int which, F f) {
  switch (which) {
    case 0: return f(masks_kernel<false>);
    case 2: return f(lanes_kernel<false, false>);
    case 3: return f(lanes_kernel<true, false>);
    case 4: return f(masks_kernel<true>);
    case 5: return f(lanes_kernel<false, true>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Blocks of build `which` (with_build's codes, but the compaction) that
// one SM holds at these dims (`n_targets` of the reconfig variant, 0 for
// the spec), as the occupancy calculator gives them (its shared memory,
// registers and threads), into *out, for chip_smoke.py.
extern "C" int chunk_front_occupancy(int which, int N, int V, int L, int M,
                                     int n_targets, int* out) {
  if (!dims_ok(N, V, L, M, n_targets)) return (int)cudaErrorInvalidValue;
  const Dims d = rtt::make_dims(N, V, L, M, n_targets);
  const size_t smem = which == 0 || which == 4
                          ? (size_t)kWarps * masks_warp_bytes(d)
                          : lanes_smem(d).bytes;
  return with_build(which, [&](auto kernel) {
    int e;
    if ((e = rtt::allow_smem(kernel, smem))) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kThreads, smem);
  });
}

// Launch `which` of one front call (with_build's codes) for chip_smoke.py.
extern "C" int chunk_front_kernel_info(int which, int N, int V, int L, int M,
                                       int n_targets, int B, int K,
                                       int* out) {
  if (!dims_ok(N, V, L, M, n_targets)) return (int)cudaErrorInvalidValue;
  const Dims d = rtt::make_dims(N, V, L, M, n_targets);
  if (which == 1)
    return rtt::kernel_info(rtt::compact_scan_kernel, rtt::scan_blocks(B),
                            rtt::kScanThreads, 0, out);
  const bool masks = which == 0 || which == 4;
  return with_build(which, [&](auto kernel) {
    return masks ? rtt::kernel_info(kernel, masks_blocks(B), kThreads,
                                    (size_t)kWarps * masks_warp_bytes(d), out)
                 : rtt::kernel_info(kernel, lanes_blocks(K), kThreads,
                                    lanes_smem(d).bytes, out);
  });
}
