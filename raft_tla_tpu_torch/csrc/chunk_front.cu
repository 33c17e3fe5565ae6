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
//      the warp writes en/ovf/pruned [B, G] and the row's hash sums
//      (ordered-part base, bag sum, per-slot hashes, parent fingerprint)
//      into a [B, 6 + 2M] scratch.
//   2. compact_kernel: one block, B3's algorithm (compact.cuh), then the
//      progress limit applied to en/ovf (rows >= P cleared).
//   3. lanes_kernel: one warp per live compacted lane (lane < total).  The
//      parent row is decoded into shared memory; every lane of the warp
//      computes the same scalars of `lane_out` (no divergence, no
//      broadcasts), the send's equal-row and free-slot searches are a
//      ballot across the slots, lane 0 applies the sparse edits and sums
//      each edited position's fingerprint delta as it writes, and the warp
//      evaluates the constraint and the invariants on the successor and
//      writes its row.
//
// Dead compacted lanes (lane >= total) are left unwritten in kh, kl, krows,
// cons_ok, inv, parent_hi and parent_lo: nothing downstream reads them (the
// fused tail reads only enqueued lanes; violations and trace links go
// through is_new, which is false there).
//
// Bound on the H100: bytes.  The function reads the B parent rows and
// writes the three [B, G] masks, lane_id/kvalid, and each live lane's row
// and scalars: about 19 MB for a full main-path window (B=2048, K=32768,
// ~32,700 live lanes), under 6 us at 3.35 TB/s.  This first version is
// written to be right, not fast: the guards loop over the message slots
// per instance, the per-lane scalar work is done 32 times over, and the
// compaction is one block (chip_smoke.py times each launch).

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

__global__ void __launch_bounds__(kThreads)
masks_kernel(Dims d, const uint8_t* __restrict__ rows,
             const uint8_t* __restrict__ valid, int B,
             const uint8_t* __restrict__ por_mask,
             const int32_t* __restrict__ por_pri,
             const uint32_t* __restrict__ salts, uint8_t* __restrict__ en_out,
             uint8_t* __restrict__ ovf_out, uint8_t* __restrict__ pruned_out,
             uint32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  uint8_t* mine = smem + (size_t)warp * masks_warp_bytes(d);
  int* sv = reinterpret_cast<int*>(mine);
  uint8_t* en_s = mine + align16(d.sw * 4);
  uint8_t* ovf_s = en_s + d.G;
  rtt::decode_row(d, rows + (size_t)b * d.sw, sv, lane);
  __syncwarp();
  const St st{d, sv};
  const bool ok_row = valid[b] != 0;

  // Guards, with the valid mask applied; the POR argmin rides along.
  // (priority biased to unsigned, g): the lowest key wins.
  unsigned long long best = ~0ull;
  bool any_amp = false;
  for (int g = lane; g < d.G; g += 32) {
    bool en, ovf;
    rtt::guard(st, g, &en, &ovf);
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
  for (int g = lane; g < d.G; g += 32) {
    const bool keep = sel < 0 || g == sel;
    const bool en = en_s[g];
    en_row[g] = en && keep;
    ovf_row[g] = ovf_s[g] && keep;
    pr_row[g] = en && !keep;
  }

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

__global__ void __launch_bounds__(rtt::kCompactThreads)
compact_kernel(uint8_t* __restrict__ en, uint8_t* __restrict__ ovf, int B,
               int G, int K, const int32_t* __restrict__ kspread,
               int32_t* __restrict__ pt, int32_t* __restrict__ lane_id,
               uint8_t* __restrict__ kvalid) {
  extern __shared__ int cum[];
  __shared__ int scratch[32];
  const int P = rtt::compact_block(en, B, G, K, kspread, pt, lane_id, kvalid,
                                   cum, scratch);
  // Progress limit: the rows past P are not taken this batch (the scan
  // above has read them all behind its barriers).
  for (int f = P * G + threadIdx.x; f < B * G; f += blockDim.x) {
    en[f] = 0;
    ovf[f] = 0;
  }
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

__global__ void __launch_bounds__(kThreads)
lanes_kernel(Dims d, const uint8_t* __restrict__ rows,
             const int32_t* __restrict__ pt,
             const int32_t* __restrict__ lane_id,
             const uint32_t* __restrict__ scratch,
             const uint32_t* __restrict__ salts, int K, rtt::Bounds bounds,
             const int32_t* __restrict__ inv_codes, int n_inv, LaneOut out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;  // compacted lane
  if (q >= K || q >= pt[1]) return;
  int* sv = reinterpret_cast<int*>(smem + (size_t)warp * align16(d.sw * 4));
  const int lid = lane_id[q];
  const int b = lid / d.G, g = lid - b * d.G;
  rtt::decode_row(d, rows + (size_t)b * d.sw, sv, lane);
  __syncwarp();
  const St st{d, sv};
  const rtt::Salts k{salts, d.D, d.W};
  const uint32_t* scr = scratch + (size_t)b * (kScr + 2 * d.M);
  const int N = d.N, L = d.L, M = d.M;

  // ---- lane_out's scalars, the same on every lane of the warp ----
  const rtt::Inst in = rtt::decode_instance(d, g);
  const int fam = in.fam;
  // Reads clamp, as JAX gathers do: a slot family's p1 is a slot index,
  // read as a server only under gates that are off for it.
  const int i = rtt::clampi(in.p1, 0, N - 1);
  const int jv = in.p2;
  const int s = in.p1;
  const int s_rd = rtt::clampi(s, 0, M - 1);
  const rtt::Recv rc = rtt::receive_ctx(st, s_rd);
  const bool is_restart = fam == 0, is_timeout = fam == 1, is_rv = fam == 2,
             is_bl = fam == 3, is_cr = fam == 4, is_ac = fam == 5,
             is_ae = fam == 6, is_recv = fam == 7, is_dup = fam == 8,
             is_drop = fam == 9;
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
      int member = 0;
      for (int n = 0; n < N; ++n) member += st.mi(i, n) >= idx || n == i;
      if (2 * member > N && idx <= ln_i) max_agree = idx;
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

  // The bag: discard, send, duplicate.
  const bool rvq_fire = is_recv && rc.en_rvq;
  const bool rej_fire = is_recv && rc.en_rej;
  const bool reply_fire = rvq_fire || rej_fire || done_fire;
  const bool disc_only = is_recv && (rc.en_rvr_drop || rc.en_rvr ||
                                     rc.en_aer_drop || rc.en_aer);
  const bool do_discard = reply_fire || disc_only || is_drop;
  const bool do_send = is_rv || is_ae || reply_fire;
  int m[rtt::kMaxW];
  if (is_rv)
    rtt::rv_msg(st, i, jv, m);
  else if (is_ae)  // AE reads clamp, as JAX gathers do
    rtt::ae_msg(st, i, rtt::clampi(jv, 0, N - 1), m);
  else
    rtt::reply_row(st, rc, rvq_fire, rej_fire, m);
  const rtt::Send sc = rtt::send_ctx_warp(st, m, s, reply_fire &&
                                          rc.cnt_s == 1, lane);
  __syncwarp();

  // ---- lane 0: the sparse edits, each with its fingerprint delta ----
  if (lane == 0) {
    int* v = sv;
    uint32_t db0 = 0, db1 = 0;
    auto put = [&](int pos, int val) {
      db0 += rtt::contrib(k, 0, pos, val) - rtt::contrib(k, 0, pos, v[pos]);
      db1 += rtt::contrib(k, 1, pos, val) - rtt::contrib(k, 1, pos, v[pos]);
      v[pos] = val;
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

    // The bag's rows and counts (msum's delta from the parent's slot
    // hashes, as lane_out computes it).
    const uint32_t sh_s0 = scr[kScr + s_rd], sh_s1 = scr[kScr + M + s_rd];
    uint32_t dm0 = 0, dm1 = 0;
    if (do_discard) {
      const int c = --v[d.o_cnt + s];
      if (c <= 0)
        for (int col = 0; col < d.W; ++col) v[d.o_msg + s * d.W + col] = 0;
      dm0 -= sh_s0;
      dm1 -= sh_s1;
    }
    if (do_send) {
      if (sc.ok) {
        if (sc.has_eq) {
          dm0 += scr[kScr + sc.idx];
          dm1 += scr[kScr + M + sc.idx];
        } else {
          for (int col = 0; col < d.W; ++col)
            v[d.o_msg + sc.idx * d.W + col] = m[col];
          dm0 += rtt::row_hash(k, 0, m, d.W);
          dm1 += rtt::row_hash(k, 1, m, d.W);
        }
        v[d.o_cnt + sc.idx] += 1;
      }
    }
    if (is_dup) {
      v[d.o_cnt + s] += 1;
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
  __syncwarp();

  // ---- the successor: constraint, invariants, packed row ----
  const bool cons = rtt::bounded_space_warp(st, bounds, lane);
  int inv = -1;
  for (int p = 0; p < n_inv && inv < 0; ++p) {
    const int code = inv_codes[p];
    const bool holds = code == rtt::PRED_TYPE_OK
                           ? rtt::type_ok_warp(st, lane)
                           : rtt::no_leader_warp(st, lane);
    if (!holds) inv = p;
  }
  uint8_t* row = out.krows + (size_t)q * d.sw;
  for (int p = lane; p < d.sw; p += 32) row[p] = (uint8_t)(sv[p] & 0xFF);
  if (lane == 0) {
    out.cons[q] = cons;
    out.inv[q] = inv;
  }
}

}  // namespace

// One front call: three launches on `stream`.  Returns a cudaError_t
// (cudaErrorInvalidValue for dims or predicates this kernel does not take).
extern "C" int chunk_front_launch(
    int N, int V, int L, int M, const void* rows, const void* valid, int B,
    int K, const void* kspread, const void* por_mask, const void* por_pri,
    const void* salts, const void* inv_codes, int n_inv, int max_term,
    int max_log_len, int max_msg_count, int max_in_flight, void* scratch,
    void* en, void* ovf, void* pruned, void* pt, void* lane_id, void* kvalid,
    void* kh, void* kl, void* krows, void* cons, void* inv, void* phi,
    void* plo, void* stream) {
  if (N < 1 || N > rtt::kMaxN || L < 1 || L > rtt::kMaxL || M < 1 ||
      M > rtt::kMaxM || V < 1 || n_inv < 0 || n_inv > rtt::kMaxInv)
    return (int)cudaErrorInvalidValue;
  const Dims d = rtt::make_dims(N, V, L, M);
  cudaStream_t st = (cudaStream_t)stream;
  int e;

  const size_t smem_a = (size_t)kWarps * masks_warp_bytes(d);
  if ((e = rtt::allow_smem(masks_kernel, smem_a))) return e;
  masks_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem_a, st>>>(
      d, (const uint8_t*)rows, (const uint8_t*)valid, B,
      (const uint8_t*)por_mask, (const int32_t*)por_pri,
      (const uint32_t*)salts, (uint8_t*)en, (uint8_t*)ovf, (uint8_t*)pruned,
      (uint32_t*)scratch);
  if ((e = (int)cudaGetLastError())) return e;

  const size_t smem_b = (size_t)B * sizeof(int);
  if ((e = rtt::allow_smem(compact_kernel, smem_b))) return e;
  compact_kernel<<<1, rtt::kCompactThreads, smem_b, st>>>(
      (uint8_t*)en, (uint8_t*)ovf, B, d.G, K, (const int32_t*)kspread,
      (int32_t*)pt, (int32_t*)lane_id, (uint8_t*)kvalid);
  if ((e = (int)cudaGetLastError())) return e;

  const size_t smem_c = (size_t)kWarps * align16(d.sw * 4);
  if ((e = rtt::allow_smem(lanes_kernel, smem_c))) return e;
  const rtt::Bounds bounds{max_term, max_log_len, max_msg_count,
                           max_in_flight};
  const LaneOut out{(int64_t*)kh,  (int64_t*)kl,  (uint8_t*)krows,
                    (uint8_t*)cons, (int64_t*)inv, (int64_t*)phi,
                    (int64_t*)plo};
  lanes_kernel<<<(K + kWarps - 1) / kWarps, kThreads, smem_c, st>>>(
      d, (const uint8_t*)rows, (const int32_t*)pt, (const int32_t*)lane_id,
      (const uint32_t*)scratch, (const uint32_t*)salts, K, bounds,
      (const int32_t*)inv_codes, n_inv, out);
  return (int)cudaGetLastError();
}
