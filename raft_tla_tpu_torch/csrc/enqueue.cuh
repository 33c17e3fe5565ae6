// Tile-wise append of rows to the next-level queue, in lane order: the
// copy of both tails, the fused tail's (csrc/fused_tail.cu) and the split
// tail's (csrc/enqueue.cu), one kernel for both.
//
// A block of kCopyThreads owns a tile of kCopyTile = 64 lanes.  Its
// enqueued lanes land in ONE contiguous byte span of the queue, starting
// at row next_count + (enqueued lanes of the tiles before it); an earlier
// launch has written one count a tile (the insert's resolve pass, or the
// split tail's count launch).  The block
//
//   1. reads its flags into a 64-bit mask, in every warp (two byte loads
//      a lane and two ballots: no shared memory, no block barrier); a
//      lane's rank and its run of adjacent enqueued lanes are bit counts
//      of that mask;
//   2. starts one bulk copy (TMA, cp.async.bulk) for each run of adjacent
//      enqueued lanes, whose rows are one contiguous span of the source,
//      from the thread of the run's first lane: the run's aligned 16-byte
//      lines land in shared memory at an address congruent (mod 16) to
//      the source, with room between runs, and the copies complete on an
//      mbarrier.  Only bytes whose aligned line would leave the rows'
//      tensor are loaded plainly;
//   3. waits for the counts (grid_dependency_wait: in the split tail the
//      flags and rows are older than the count launch, so steps 1-2 run
//      before the wait) and sums those of the tiles before its own, a
//      part a warp, while the copies are in flight;
//   4. waits for the copies (the turn's one block barrier) and stores the
//      span with aligned 16-byte stores, each put together from two
//      aligned 16-byte shared loads by funnel shifts (from four where a
//      line straddles two runs), peeling the unaligned head and tail as
//      bytes.  Rows are 473 bytes on the main path, 473 = 9 (mod 16), so
//      neither the runs nor the span are aligned in general, and their
//      phases differ.
//
// A tile whose rows outgrow the stage (rows above (kStageBytes - 64) / 64
// - 32 = 479 bytes: 679 B rows go 45 a turn, 951 B 33, the widest, 32,672
// B, one) is staged in turns; turns after the first copy after the wait.
// Byte offsets into the queue are 64-bit: (2^21 + 32,768) rows of 473
// bytes just fit 31 bits, a larger queue does not.
//
// Bound on the H100: bytes, the K flags and each enqueued row read once
// and written once (a real depth-8 batch, 7,577 rows of 473 bytes: 7.2
// MB, 2.1 us at 3.35 TB/s; all 32,768 lanes: 31 MB, 9.3 us).  Above it is
// latency: a tile's flags, the copies' round trip (the counts' sum hides
// behind it), the stores' funnel shifts and the stores.  chip_smoke.py
// --enqueue-variants measures this design against a gather of 16-byte
// loads through registers, and times its steps (PERF.md has the table).

#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kCopyThreads = 256;
constexpr int kCopyWarps = kCopyThreads / 32;
constexpr int kCopyTile = 64;       // lanes of one tile: bits of a mask
constexpr int kStageBytes = 32768;  // 64 rows of 473 bytes, 32 B a run more
constexpr int kWidestRow = kStageBytes - 64 - 32;  // one row a turn
constexpr int kRunWarps = kCopyTile / 32;  // warps holding the run starts
static_assert(kCopyThreads >= kCopyTile, "a thread a lane of the tile");

// The shared memory of one tile block.
struct TileStage {
  uint8_t bytes[kStageBytes];  // the rows of a turn, runs congruent
  int row_off[kCopyTile];      // byte of row r in `bytes`, less r * sw
  int part[kCopyWarps];        // each warp's part of the counts' sum
  unsigned long long bar;      // the copies' mbarrier
};

// Tiles (blocks of the tile launch, ints of the count scratch) of n lanes:
// at least one, whose block writes the count when n is 0.
__host__ __device__ inline int copy_tiles(int n) {
  return n > 0 ? (n + kCopyTile - 1) / kCopyTile : 1;
}

// Rows of `sw` bytes a stage turn takes (>= 1: the wrappers check sw <=
// kWidestRow).
__device__ __forceinline__ int turn_rows(int sw) {
  return (kStageBytes - 64) / (sw + 32);
}

// Each warp's part of the sum of counts[0 .. t) into part[warp]
// (counts 16-byte aligned); the sum is theirs after a __syncthreads.
// The counts come from the launch before, read from L2.
__device__ __forceinline__ void sum_before(const int* counts, int t,
                                           int* part) {
  int mine = 0;
  const int4* v = reinterpret_cast<const int4*>(counts);
  for (int i = threadIdx.x; i < t / 4; i += kCopyThreads) {
    const int4 w = __ldcg(v + i);
    mine += w.x + w.y + w.z + w.w;
  }
  if ((int)threadIdx.x < t % 4)
    mine += __ldcg(counts + (t & ~3) + threadIdx.x);
  mine = (int)__reduce_add_sync(0xffffffffu, (unsigned)mine);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mine;
}

// The 16 bytes at byte `sh` (0..15) of the 32 bytes a, b: words picked
// by selects (no branch), then funnel shifts.
__device__ __forceinline__ uint4 extract16(const uint4& a, const uint4& b,
                                           int sh) {
  const bool two = sh & 8, one = sh & 4;
  const uint32_t u0 = two ? a.z : a.x, u1 = two ? a.w : a.y;
  const uint32_t u2 = two ? b.x : a.z, u3 = two ? b.y : a.w;
  const uint32_t u4 = two ? b.z : b.x, u5 = two ? b.w : b.y;
  const uint32_t w0 = one ? u1 : u0, w1 = one ? u2 : u1;
  const uint32_t w2 = one ? u3 : u2, w3 = one ? u4 : u3;
  const uint32_t w4 = one ? u5 : u4;
  const int s = 8 * (sh & 3);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

// Bytes [0, c) of x, bytes [c, 4) of y.
__device__ __forceinline__ uint32_t blend4(uint32_t x, uint32_t y, int c) {
  if (c >= 4) return x;
  if (c <= 0) return y;
  const uint32_t keep = (1u << (8 * c)) - 1u;
  return (x & keep) | (y & ~keep);
}

// Bytes [0, m) of x, bytes [m, 16) of y (0 <= m <= 16).
__device__ __forceinline__ uint4 blend16(const uint4& x, const uint4& y,
                                         int m) {
  return make_uint4(blend4(x.x, y.x, m), blend4(x.y, y.y, m - 4),
                    blend4(x.z, y.z, m - 8), blend4(x.w, y.w, m - 12));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// `p` rounded down (up = 0) or up (up = 15) to a 16-byte line.
__device__ __forceinline__ const uint8_t* line_of(const uint8_t* p,
                                                  uintptr_t up) {
  return reinterpret_cast<const uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + up) & ~uintptr_t(15));
}

// The tile block's mbarrier: one arrival a turn from each of the
// kRunWarps warps.  Thread 0 calls it before the block's first barrier.
__device__ __forceinline__ void stage_init(TileStage& st) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(&st.bar)),
               "r"(kRunWarps)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// x less its k lowest set bits.
__device__ __forceinline__ unsigned long long drop_low(unsigned long long x,
                                                       int k) {
  for (; k > 0 && x; --k) x &= x - 1;
  return x;
}

// Bits [0, i) of a 64-bit mask.
__device__ __forceinline__ unsigned long long below(int i) {
  return i ? ~0ull >> (64 - i) : 0ull;
}

// The rows of ranks [r0, r0 + rows) among the lanes t0 + i of the tile's
// mask `f` (bit i), from `krows` (its rows end at `kend`) into the stage,
// by the threads of the tile's lanes: step 2 above.  The copies may still
// be in flight on return; stage_wait completes them.
__device__ __forceinline__ void stage_issue(const uint8_t* __restrict__ krows,
                                            const uint8_t* kend, int sw,
                                            int t0, unsigned long long f,
                                            int r0, int rows, TileStage& st) {
  const int i = threadIdx.x;
  if (i >= kCopyTile) return;
  // The turn's lanes, then the first lane of each run of them.
  unsigned long long turn = drop_low(f, r0);
  if (rows < __popcll(turn)) turn &= ~drop_low(turn, rows);
  const unsigned long long starts = turn & ~(turn << 1);
  int bytes = 0;
  const uint8_t* c0 = nullptr;
  uint8_t* dst = nullptr;
  if ((starts >> i) & 1) {
    const unsigned long long up = ~(turn >> i);  // 0 bits: the run
    const int m = up ? __ffsll((long long)up) - 1 : 64 - i;
    const int rs = __popcll(turn & below(i));  // the run's first row
    const int j = __popcll(starts & below(i));  // the run's index
    const uint8_t* a = krows + (size_t)(t0 + i) * sw;
    const int len = m * sw;
    // Run j from stage byte rs * sw + 32 j + 16 + (a - rs * sw mod 16):
    // congruent to a, and its lines clear of its neighbours' lines.
    const int off = 32 * j + 16 + (int)((reinterpret_cast<uintptr_t>(a) -
                                         (uintptr_t)rs * sw) & 15);
    for (int r = rs; r < rs + m; ++r) st.row_off[r] = off;
    uint8_t* s = st.bytes + off + rs * sw;  // the run's first byte
    // The run's aligned lines that lie inside the tensor.
    const uint8_t* lo = line_of(krows, 15);
    const uint8_t* hi = line_of(kend, 0);
    c0 = line_of(a, 0) < lo ? lo : line_of(a, 0);
    const uint8_t* c1 = line_of(a + len, 15);
    c1 = c1 > hi ? hi : c1;
    if (c1 > c0) {
      bytes = (int)(c1 - c0);
      dst = s + (c0 - a);
    } else {
      c0 = c1 = a;
    }
    for (const uint8_t* p = a; p < c0; ++p) s[p - a] = *p;
    for (const uint8_t* p = c1 > a ? c1 : a; p < a + len; ++p)
      s[p - a] = *p;
  }
  const uint32_t bar = smem_u32(&st.bar);
  const unsigned warp_bytes = __reduce_add_sync(0xffffffffu, (unsigned)bytes);
  if ((i & 31) == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(warp_bytes) : "memory");
  __syncwarp();
  if (bytes) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(c0)), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// Completes the copies of turn `turn` (counted from 0 in the block).
__device__ __forceinline__ void stage_wait(TileStage& st, int turn) {
  const uint32_t bar = smem_u32(&st.bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(turn & 1)
        : "memory");
  __syncthreads();
}

// The 16 stage bytes from byte p.
__device__ __forceinline__ uint4 stage16(const TileStage& st, int p) {
  const uint4* s = reinterpret_cast<const uint4*>(st.bytes);
  return extract16(s[p >> 4], s[(p >> 4) + 1], p & 15);
}

// The `rows` rows of `sw` bytes staged by stage_issue to `dst`, by the
// whole block.
__device__ __forceinline__ void store_turn(const TileStage& st,
                                           uint8_t* __restrict__ dst,
                                           int rows, int sw) {
  const int t = threadIdx.x;
  const int len = rows * sw;
  if (sw < 16) {  // a line could span three runs: bytes
    for (int k = t; k < len; k += kCopyThreads)
      dst[k] = st.bytes[st.row_off[k / sw] + k];
    return;
  }
  const int head = min(len, (int)((16 - (reinterpret_cast<uintptr_t>(dst) &
                                         15)) & 15));
  if (t < head) dst[t] = st.bytes[st.row_off[t / sw] + t];
  const int vecs = (len - head) >> 4;
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  const float rcp = 1.0f / (float)sw;
  for (int i = t; i < vecs; i += kCopyThreads) {
    const int k = head + 16 * i;  // the line's first byte in the span
    int r = (int)((float)k * rcp);  // k / sw, corrected below
    r -= r * sw > k;
    r += (r + 1) * sw <= k;
    const int next = (r + 1) * sw;  // where row r + 1 starts in the span
    const int off = st.row_off[r];
    uint4 v = stage16(st, off + k);
    if (k + 16 > next && st.row_off[r + 1] != off)  // it straddles two runs
      v = blend16(v, stage16(st, st.row_off[r + 1] + k), next - k);
    d[i] = v;
  }
  const int done = head + 16 * vecs;
  if (t < len - done)
    dst[done + t] = st.bytes[st.row_off[(done + t) / sw] + done + t];
}

// The tile's flags as a mask (bit i: lane t0 + i), in every warp: lane
// k of each warp loads the flags of lanes t0 + k and t0 + 32 + k.
template <bool kSplit>
__device__ __forceinline__ unsigned long long tile_flags(const uint8_t* a,
                                                         const uint8_t* b,
                                                         int t0, int n) {
  const int k = threadIdx.x & 31;
  const int l0 = t0 + k, l1 = t0 + 32 + k;
  const bool in0 = l0 < n, in1 = l1 < n;
  // Both arrays' loads go out together (no short circuit between them),
  // from L2: the fused tail's is_new was written by the launch before.
  const uint8_t a0 = in0 ? __ldcg(a + l0) : 0;
  const uint8_t a1 = in1 ? __ldcg(a + l1) : 0;
  const uint8_t b0 = kSplit || !in0 ? 1 : __ldcg(b + l0);
  const uint8_t b1 = kSplit || !in1 ? 1 : __ldcg(b + l1);
  const unsigned lo = __ballot_sync(0xffffffffu, a0 && b0);
  const unsigned hi = __ballot_sync(0xffffffffu, a1 && b1);
  return (unsigned long long)hi << 32 | lo;
}

// The tile launch of both tails: a block per tile.  The flag of lane l is
// a[l] && b[l] (fused tail: is_new, written by the launch before this
// one, and enq_ok), or a[l] alone (split tail: enq, older than the count
// launch this one follows).  tile_count[t] is the flags set in tile t;
// the block of the last tile writes count_out.  Rows at and past the new
// count are left as they were.  *next_count is read after the wait, from
// L2: in the level loop it is written on the card just before the call
// (or, chained, it is the count_out of the call before).  count_out must
// not be next_count: other blocks may still read it.
template <bool kSplit>
__global__ void __launch_bounds__(kCopyThreads)
enqueue_tiles_kernel(const uint8_t* a, const uint8_t* b,
                     const int* tile_count, int n,
                     const uint8_t* __restrict__ krows, int sw,
                     uint8_t* __restrict__ qnext, const int* next_count,
                     int* count_out) {
  __shared__ __align__(16) TileStage st;
  if (threadIdx.x == 0) stage_init(st);
  if (!kSplit) grid_dependency_wait();
  const int t = blockIdx.x;
  const int t0 = t * kCopyTile;
  const unsigned long long f = tile_flags<kSplit>(a, b, t0, n);
  const int total = __popcll(f);
  const uint8_t* kend = krows + (size_t)n * sw;
  const int per = turn_rows(sw);
  int rows = min(per, total);
  // The barrier publishes stage_init before any warp arrives on it.
  __syncthreads();
  stage_issue(krows, kend, sw, t0, f, 0, rows, st);
  if (kSplit) grid_dependency_wait();
  sum_before(tile_count, t, st.part);
  long long first = __ldcg(next_count);
  for (int r0 = 0, turn = 0;; ++turn) {
    stage_wait(st, turn);
    if (turn == 0)
      for (int w = 0; w < kCopyWarps; ++w) first += st.part[w];
    store_turn(st, qnext + (first + r0) * (long long)sw, rows, sw);
    r0 += rows;
    if (r0 >= total) break;
    __syncthreads();
    rows = min(per, total - r0);
    stage_issue(krows, kend, sw, t0, f, r0, rows, st);
  }
  if (threadIdx.x == 0 && t == (int)gridDim.x - 1)
    count_out[0] = (int)(first + total);
}

}  // namespace rtt
