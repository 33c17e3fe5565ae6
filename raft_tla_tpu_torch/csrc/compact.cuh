// Progress-limited lane compaction across many blocks: the scan-and-write
// launch shared by compact.cu (the v3 compaction kernel) and
// chunk_front.cu (the v4 front's compaction launch).
//
// Contract (raft_tla_tpu/ops/compact.py build_compactor):
//   per-parent fan-out -> cumsum -> P = #{b : cum[b] <= K} (the longest
//   parent prefix whose fan-out fits K, with the zero fan-out rows after
//   the last row that fits) -> total = cum[P-1] -> kvalid = arange(K) <
//   total -> lane_id = ascending flat indices of the enabled lanes of the
//   first P parents, with kspread in the dead slots.
//
// The launch before this one writes each row's fan-out to counts[B] (a
// warp a row: compact.cu's count_kernel on v3, the masks launch on v4).
// This launch is a grid of blocks, each owning kScanRows consecutive rows.
// Every block reads all B counts (8 KB at B = 2048, out of L2) and scans
// them itself, so it knows P, total and its own rows' bases without
// waiting for any other block: no inter-block dependency, no atomics, one
// launch, the result independent of the order the blocks run in (the
// trick of enqueue.cu).  A block's warps then write the lane ids of its
// rows below P, a warp a row, each lane's rank from a ballot over 32 flags
// at a time, so the output stays in ascending flat-lane order.  All blocks
// write kvalid and the dead slots' kspread grid-stride, block 0 writes
// (P, total), and on v4 each block clears its own rows >= P in en and ovf.
//
// Why not a decoupled look-back scan: it would save the redundant reads
// of the counts (B ints a block) but makes each block wait on its
// predecessors' flags; at B = 2048 the whole count vector is one L2 read a
// block, which costs less than that chain.
#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kScanThreads = 256;
constexpr int kScanRows = 16;  // rows a scan-and-write block owns

inline int scan_blocks(int B) { return (B + kScanRows - 1) / kScanRows; }

// One block of the scan-and-write launch (kScanThreads threads).  `en`
// [B, G] flags, `counts` [B] their row sums; `clear_en` / `clear_ovf`
// (v4, may alias `en`) get their rows >= P zeroed, when not null.
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const uint8_t* en, const int32_t* __restrict__ counts,
                    int B, int G, int K, const int32_t* __restrict__ kspread,
                    int32_t* __restrict__ pt, int32_t* __restrict__ lane_id,
                    uint8_t* __restrict__ kvalid, uint8_t* clear_en,
                    uint8_t* clear_ovf) {
  __shared__ int scratch[32];
  __shared__ int row_base[kScanRows];
  __shared__ int first_base, total_sh;
  const int T = blockDim.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * kScanRows;

  // 1. The inclusive cumsum of all B counts, a contiguous chunk a thread.
  const int per = (B + T - 1) / T;
  const int b0 = min(t * per, B), b1 = min(b0 + per, B);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += counts[b];
  int unused;
  const int start = block_exclusive_scan(local, &unused, scratch);

  // 2. P = #{b : cum[b] <= K} (cum is non-decreasing); this block's base.
  int run = start, fits = 0;
  for (int b = b0; b < b1; ++b) {
    if (b == r0) first_base = run;
    run += counts[b];
    fits += run <= K;
  }
  int P;
  block_exclusive_scan(fits, &P, scratch);
  // total = cum[P-1], from the thread whose chunk holds row P-1.
  if (P == 0 ? t == 0 : (b0 <= P - 1 && P - 1 < b1)) {
    int c = start;
    for (int b = b0; b < P; ++b) c += counts[b];
    total_sh = c;
  }
  __syncthreads();
  const int total = total_sh;
  if (warp == 0) {
    const int b = r0 + lane;
    const int c = (lane < kScanRows && b < B) ? counts[b] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < kScanRows) row_base[lane] = first_base + x - c;
  }
  if (blockIdx.x == 0 && t == 0) {
    pt[0] = P;
    pt[1] = total;
  }

  // 3. kvalid, and kspread in the dead slots, over the whole grid.
  for (int k = blockIdx.x * T + t; k < K; k += gridDim.x * T) {
    kvalid[k] = k < total;
    if (k >= total) lane_id[k] = kspread[k];
  }
  __syncthreads();

  // 4. This block's rows: survivors of rows < P in ascending flat order,
  //    the progress limit on rows >= P.
  for (int i = warp; i < kScanRows; i += T >> 5) {
    const int b = r0 + i;
    if (b >= B) break;
    if (b < P) {
      const uint8_t* row = en + (size_t)b * G;
      int base = row_base[i];
      for (int g0 = 0; g0 < G; g0 += 32) {
        const int g = g0 + lane;
        const bool f = g < G && row[g] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (f) lane_id[base + __popc(m & ((1u << lane) - 1u))] = b * G + g;
        base += __popc(m);
      }
    } else if (clear_en) {
      for (int g = lane; g < G; g += 32) {
        clear_en[(size_t)b * G + g] = 0;
        clear_ovf[(size_t)b * G + g] = 0;
      }
    }
  }
}

}  // namespace rtt
