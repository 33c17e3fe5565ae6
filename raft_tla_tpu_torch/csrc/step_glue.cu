// The chunk step's bookkeeping around the front and the tail: one launch
// before each batch and one after it.
//
// Replaces no TPU kernel.  In the JAX package these lines (engine/chunk.py
// cond, the window, finish and update) run inside the chunk's while_loop
// body, where XLA fuses them with the rest of the step.  The port ran each
// line as its own PyTorch operation, ~88 launches of a few KB each around
// the front's three and the tail's four; both launches here take their
// place (engine/chunk.py ChunkStep keeps the PyTorch lines as their plain
// versions):
//
//   1. step_begin_kernel: every block evaluates the loop's cond itself
//      from the ~10 control words and the seen set's size (no block waits
//      on another), writes `a`, the batch's `valid` flags, and gathers its
//      B rows from the level queue at the device offset.  Those rows are
//      one contiguous span of the queue (rows past its end repeat its last
//      row, the plain version's clamp), so the gather is a copy of B * sw
//      bytes with 16-byte loads and stores; the span's start is aligned to
//      no more than a byte, and one shift, the same in every thread,
//      realigns each pair of 16-byte loads.  With B = 0 the launch only
//      writes the cond into a control word (the one a burst of steps ends
//      with).
//   2. step_end_kernel: a warp a row reduces the front's [B, G] enabled
//      and overflow flags (and the POR-pruned ones when a table is on),
//      a flag a lane, to the row's dead flag, the overflow count and
//      per-family counts, a thread a lane the K lanes' novel flags to
//      per-family counts and the first violating lane.  Each block sums in shared memory and adds to a
//      small scratch with integer atomics; the last block to take a
//      ticket applies the batch's delta to the state words, a thread a
//      word (nothing when the cond was false), copies the first violating
//      row and the first deadlocked parent, and resets the scratch and the
//      ticket for the next launch.  "First" is the lowest index, as argmax of the flags
//      gives it, and every sum is an integer, so the state is bit-exact
//      whatever order the blocks run in.
//
// Bound on the H100: launch latency.  At the main path's shapes (B 2048,
// G 132, K 32,768, 473-byte rows) the end launch reads ~1 MB (the two
// [B, G] masks 540 KB, inv 256 KB, lane_id 128 KB, only on novel lanes)
// and the begin launch copies 969 KB: about 0.3 us each at 3.35 TB/s
// against a launch's ~2-3 us.  So each is one launch with enough blocks to
// stream its bytes once and no intermediate tensor.

#include "common.cuh"

namespace {

// ChunkState.st's words (engine/chunk.py ST_*).
enum {
  ST_OFFSET, ST_STEPS, ST_COUNT, ST_SEEN, ST_TCOUNT, ST_GEN, ST_NEW, ST_OVF,
  ST_DEAD, ST_VIOL, ST_VINV, ST_FAIL, ST_EXPANDED, N_SCALARS
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCond = 8;
constexpr int kMaxFamilies = 32;
constexpr int kMaxBlocks = 4 * 132;  // a few blocks on each SM
constexpr int kNone = 0x7fffffff;

// The end launch's scratch words (int32): the ticket, three sums, the
// first violating lane and deadlocked row, then per family the enabled,
// novel and pruned counts.
enum { SC_TICKET, SC_NEW, SC_OVF, SC_EXPANDED, SC_VIOL, SC_DEAD, SC_FAM };

// The loop's cond: st[word[j]] <= lim[j] for each j, where the first two
// limits are the control words at cur less one (the level's rows, the
// step limit), and the seen set at most half full.
struct Cond {
  int n;
  int word[kMaxCond];
  int lim[kMaxCond];
  int cur;
  int count_word;
  long long half_cap;
};

__device__ __forceinline__ int32_t add_wrap(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ bool eval_cond(const int32_t* st, const Cond& c,
                                          const int64_t* seen_size) {
  bool ok = *seen_size <= c.half_cap;
#pragma unroll
  for (int j = 0; j < kMaxCond; ++j) {
    if (j < c.n) {
      const int32_t rhs = j < 2 ? add_wrap(st[c.cur + j], -1) : c.lim[j];
      ok = ok && st[c.word[j]] <= rhs;
    }
  }
  return ok;
}

// 16 bytes starting at byte s (1..15) of the 32 bytes lo, hi.
__device__ __forceinline__ uint4 shift16(uint4 lo, uint4 hi, int s) {
  const int r = (s & 3) * 8;
  uint32_t w0, w1, w2, w3, w4;
  switch (s >> 2) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  return make_uint4(__funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
                    __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
}

// `st` is no __restrict__ pointer: the cond-only launch writes through
// `more` into it.
__global__ void __launch_bounds__(kThreads)
step_begin_kernel(const int32_t* st, Cond c, const int64_t* seen_size,
                  const uint8_t* __restrict__ qcur, long long q_rows, int sw,
                  int B, uint8_t* __restrict__ rows,
                  uint8_t* __restrict__ valid, uint8_t* __restrict__ a_out,
                  int32_t* more) {
  __shared__ int s_a;
  if (threadIdx.x == 0) s_a = eval_cond(st, c, seen_size);
  __syncthreads();
  const bool a = s_a;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (a_out) *a_out = a;
    if (more) *more = a;
  }
  if (B == 0) return;
  const long long off = st[ST_OFFSET];
  const long long limit = st[c.count_word];
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long b = t; b < B; b += stride) valid[b] = a && off + b < limit;

  // Rows [0, nc) are the queue's rows from off on, one span of bytes.
  const long long nc = max(0LL, min((long long)B, q_rows - off));
  const long long chunks = nc * sw / 16;
  if (chunks) {
    const uintptr_t src = (uintptr_t)(qcur + off * sw);
    const int s = (int)(src & 15);
    const uint4* base = reinterpret_cast<const uint4*>(src - s);
    uint4* dst = reinterpret_cast<uint4*>(rows);
    // Each load holds a byte of the span, so none reads past the queue.
    if (s == 0) {
      for (long long i = t; i < chunks; i += stride) dst[i] = __ldg(base + i);
    } else {
      for (long long i = t; i < chunks; i += stride)
        dst[i] = shift16(__ldg(base + i), __ldg(base + i + 1), s);
    }
  }
  // The span's last partial chunk, and rows clamped to the queue's last.
  const long long total = (long long)B * sw;
  for (long long i = chunks * 16 + t; i < total; i += stride) {
    const long long b = i / sw;
    const long long r = max(0LL, min(off + b, q_rows - 1));
    rows[i] = qcur[r * sw + (i - b * sw)];
  }
}

struct End {
  const uint8_t* a;        // [1] the cond
  const uint8_t* valid;    // [B]
  const uint8_t* rows;     // [B, sw] the window
  const uint8_t* en;       // [B, G], rows >= P clear
  const uint8_t* ovf;      // [B, G], rows >= P clear
  const uint8_t* pruned;   // [B, G] or null (no POR table)
  const int32_t* P;
  const int32_t* total;
  const int32_t* lane_id;  // [K]
  const uint8_t* is_new;   // [K]
  const int64_t* inv;      // [K], read on novel lanes only
  const int64_t* kh;       // [K]
  const int64_t* kl;       // [K]
  const uint8_t* krows;    // [K, sw]
  const uint8_t* fail;     // [1]
  const int32_t* count;    // [1] the queue count after the tail
  const int64_t* seen_size;
  const int32_t* fam;      // [G] the family of each grid instance
  int B, G, K, F, sw;
  int32_t* st;
  uint8_t* vrow;
  int64_t* vfp;
  uint8_t* drow;
  int32_t* scratch;
};

// Adds 1 to hist[f] for each lane of the warp with x, one shared atomic a
// family (all 32 lanes call it).
__device__ __forceinline__ void count_family(bool x, int f, int* hist) {
  const unsigned m = __ballot_sync(0xffffffffu, x);
  if (x) {
    const unsigned peers = __match_any_sync(m, f);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[f], __popc(peers));
  }
}

// The increment of state word i when the cond held: ST_COUNT, ST_SEEN,
// ST_TCOUNT and ST_VINV are set, not added (engine/chunk.py finish).
__device__ __forceinline__ int32_t delta_of(int i, const int* tot, int P,
                                            int total, int fail) {
  switch (i) {
    case ST_OFFSET: return P;
    case ST_STEPS: return 1;
    case ST_GEN: return total;
    case ST_NEW: return tot[SC_NEW];
    case ST_OVF: return tot[SC_OVF];
    case ST_DEAD: return tot[SC_DEAD] != kNone;
    case ST_VIOL: return tot[SC_VIOL] != kNone;
    case ST_FAIL: return fail;
    case ST_EXPANDED: return tot[SC_EXPANDED];
    default: return i >= N_SCALARS ? tot[SC_FAM + i - N_SCALARS] : 0;
  }
}

__global__ void __launch_bounds__(kThreads) step_end_kernel(End e) {
  __shared__ int s_fam[3 * kMaxFamilies];  // enabled, novel, pruned
  __shared__ int s_sum[3];                 // novel, overflow, expanded
  __shared__ int s_first[2];               // violating lane, dead row
  __shared__ int s_tot[SC_FAM + 3 * kMaxFamilies];
  __shared__ int s_last, s_take_v, s_take_d, s_total, s_fail, s_count, s_seen;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < 3 * kMaxFamilies; i += kThreads) s_fam[i] = 0;
  if (t < 3) s_sum[t] = 0;
  if (t < 2) s_first[t] = kNone;
  __syncthreads();
  const int P = *e.P;

  // A warp a row of the [B, G] flags.
  for (int b = blockIdx.x * kWarps + warp; b < e.B; b += gridDim.x * kWarps) {
    const size_t row = (size_t)b * e.G;
    const bool taken = b < P;
    bool any_en = false;
    int n_ovf = 0;
    for (int g0 = 0; g0 < e.G; g0 += 32) {  // a lane a flag
      const int g = g0 + lane;
      const bool in = g < e.G;
      const int f = in ? e.fam[g] : 0;
      const bool x = in && e.en[row + g];
      any_en |= x;
      n_ovf += in && e.ovf[row + g];
      count_family(x, f, s_fam);
      if (e.pruned)
        count_family(in && taken && e.pruned[row + g], f,
                     s_fam + 2 * kMaxFamilies);
    }
    any_en = __any_sync(0xffffffffu, any_en);
    n_ovf = __reduce_add_sync(0xffffffffu, n_ovf);
    if (lane == 0) {
      if (n_ovf) atomicAdd(&s_sum[1], n_ovf);
      if (taken && e.valid[b]) {
        atomicAdd(&s_sum[2], 1);
        if (!any_en && !n_ovf) atomicMin(&s_first[1], b);
      }
    }
  }

  // A thread a lane of the K compacted lanes.
  int n_new = 0;
  for (int k0 = blockIdx.x * kThreads + warp * 32; k0 < e.K;
       k0 += gridDim.x * kThreads) {
    const int k = k0 + lane;
    const bool x = k < e.K && e.is_new[k];
    int f = 0;
    if (x) {
      f = e.fam[e.lane_id[k] % e.G];
      if (e.inv[k] >= 0) atomicMin(&s_first[0], k);
    }
    n_new += x;
    count_family(x, f, s_fam + kMaxFamilies);
  }
  n_new = __reduce_add_sync(0xffffffffu, n_new);
  if (lane == 0 && n_new) atomicAdd(&s_sum[0], n_new);
  __syncthreads();

  int32_t* sc = e.scratch;
  for (int i = t; i < 3 * e.F; i += kThreads) {
    const int v = s_fam[(i / e.F) * kMaxFamilies + i % e.F];
    if (v) atomicAdd(&sc[SC_FAM + i], v);
  }
  if (t < 3 && s_sum[t]) atomicAdd(&sc[SC_NEW + t], s_sum[t]);
  if (t < 2 && s_first[t] != kNone) atomicMin(&sc[SC_VIOL + t], s_first[t]);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&sc[SC_TICKET], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block: every other block's sums are in the scratch.  Take
  // them and leave the scratch as the next launch expects it.
  __threadfence();
  const int n_sc = SC_FAM + 3 * e.F;
  for (int i = t; i < n_sc; i += kThreads)
    s_tot[i] = atomicExch(&sc[i], i == SC_VIOL || i == SC_DEAD ? kNone : 0);
  __syncthreads();
  const bool a = *e.a;
  int32_t* st = e.st;
  if (t == 0) {  // the first violation and deadlock of the chunk win
    s_take_v = a && st[ST_VIOL] == 0 && s_tot[SC_VIOL] != kNone;
    s_take_d = a && st[ST_DEAD] == 0 && s_tot[SC_DEAD] != kNone;
    s_total = *e.total;
    s_fail = *e.fail != 0;
    s_count = *e.count;
    s_seen = (int32_t)*e.seen_size;
  }
  __syncthreads();
  const int vpos = s_tot[SC_VIOL], dpos = s_tot[SC_DEAD];
  if (s_take_v)
    for (int i = t; i < e.sw; i += kThreads)
      e.vrow[i] = e.krows[(size_t)vpos * e.sw + i];
  if (s_take_d)
    for (int i = t; i < e.sw; i += kThreads)
      e.drow[i] = e.rows[(size_t)dpos * e.sw + i];
  if (t == 0 && s_take_v) {
    e.vfp[0] = e.kh[vpos];
    e.vfp[1] = e.kl[vpos];
  }
  // A thread a state word.
  for (int i = t; i < N_SCALARS + 3 * e.F; i += kThreads) {
    int32_t v = i == ST_COUNT                ? s_count
                : i == ST_SEEN               ? s_seen
                : i == ST_VINV && s_take_v   ? (int32_t)e.inv[vpos]
                                             : st[i];
    if (a) v = add_wrap(v, delta_of(i, s_tot, P, s_total, s_fail));
    st[i] = v;
  }
}

int begin_blocks(int B, int sw) {
  const long long work = max((long long)B, (long long)B * sw / 16);
  return (int)max(1LL, min((long long)kMaxBlocks,
                           (work + kThreads - 1) / kThreads));
}

int end_blocks(int B, int K) {
  const int rows = (B + kWarps - 1) / kWarps;
  const int lanes = (K + kThreads - 1) / kThreads;
  return max(1, min(kMaxBlocks, max(rows, lanes)));
}

Cond make_cond(const int* words, const int* lims, int n, int cur,
               int count_word, long long half_cap) {
  Cond c = {};
  c.n = n;
  for (int j = 0; j < n; ++j) {
    c.word[j] = words[j];
    c.lim[j] = lims[j];
  }
  c.cur = cur;
  c.count_word = count_word;
  c.half_cap = half_cap;
  return c;
}

}  // namespace

// B = 0 launches one block that writes the cond into `more` alone.
extern "C" int step_begin_launch(const void* st, const int* words,
                                 const int* lims, int n, int cur,
                                 int count_word, const void* seen_size,
                                 long long half_cap, const void* qcur,
                                 long long q_rows, int sw, int B, void* rows,
                                 void* valid, void* a_out, void* more,
                                 void* stream) {
  if (n < 2 || n > kMaxCond) return (int)cudaErrorInvalidValue;
  const Cond c = make_cond(words, lims, n, cur, count_word, half_cap);
  step_begin_kernel<<<B ? begin_blocks(B, sw) : 1, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)st, c, (const int64_t*)seen_size,
      (const uint8_t*)qcur, q_rows, sw, B, (uint8_t*)rows, (uint8_t*)valid,
      (uint8_t*)a_out, (int32_t*)more);
  return (int)cudaGetLastError();
}

extern "C" int step_end_launch(
    const void* a, const void* valid, const void* rows, const void* en,
    const void* ovf, const void* pruned, const void* P, const void* total,
    const void* lane_id, const void* is_new, const void* inv, const void* kh,
    const void* kl, const void* krows, const void* fail, const void* count,
    const void* seen_size, const void* fam, int B, int G, int K, int F,
    int sw, void* st, void* vrow, void* vfp, void* drow, void* scratch,
    void* stream) {
  if (F < 1 || F > kMaxFamilies) return (int)cudaErrorInvalidValue;
  End e;
  e.a = (const uint8_t*)a;
  e.valid = (const uint8_t*)valid;
  e.rows = (const uint8_t*)rows;
  e.en = (const uint8_t*)en;
  e.ovf = (const uint8_t*)ovf;
  e.pruned = (const uint8_t*)pruned;
  e.P = (const int32_t*)P;
  e.total = (const int32_t*)total;
  e.lane_id = (const int32_t*)lane_id;
  e.is_new = (const uint8_t*)is_new;
  e.inv = (const int64_t*)inv;
  e.kh = (const int64_t*)kh;
  e.kl = (const int64_t*)kl;
  e.krows = (const uint8_t*)krows;
  e.fail = (const uint8_t*)fail;
  e.count = (const int32_t*)count;
  e.seen_size = (const int64_t*)seen_size;
  e.fam = (const int32_t*)fam;
  e.B = B;
  e.G = G;
  e.K = K;
  e.F = F;
  e.sw = sw;
  e.st = (int32_t*)st;
  e.vrow = (uint8_t*)vrow;
  e.vfp = (int64_t*)vfp;
  e.drow = (uint8_t*)drow;
  e.scratch = (int32_t*)scratch;
  step_end_kernel<<<end_blocks(B, K), kThreads, 0, (cudaStream_t)stream>>>(e);
  return (int)cudaGetLastError();
}

// out[0] = the scratch's words for F families, out[1] the most families and
// out[2] the most cond words the kernels take.
extern "C" void step_glue_geometry(int F, int* out) {
  out[0] = SC_FAM + 3 * F;
  out[1] = kMaxFamilies;
  out[2] = kMaxCond;
}

// Launch `which` of a step (0 begin, 1 end) for chip_smoke.py.
extern "C" int step_glue_kernel_info(int which, int B, int sw, int K,
                                     int* out) {
  if (which == 0)
    return rtt::kernel_info(step_begin_kernel, begin_blocks(B, sw), kThreads,
                            0, out);
  if (which == 1)
    return rtt::kernel_info(step_end_kernel, end_blocks(B, K), kThreads, 0,
                            out);
  return (int)cudaErrorInvalidValue;
}
