// Progress-limited lane compaction by one block: the device code shared by
// compact.cu (the v3 compaction kernel) and chunk_front.cu (the v4 front's
// compaction launch).
//
// Contract (raft_tla_tpu/ops/compact.py build_compactor):
//   per-parent fan-out -> cumsum -> P = longest parent prefix whose fan-out
//   fits K -> total -> kvalid = arange(K) < total -> lane_id = ascending
//   flat indices of the enabled lanes of the first P parents, with
//   kspread in the dead slots.
//
// A warp per parent counts fan-out, the B counts are scanned in shared
// memory, and the flat flags are scanned tile by tile (8 per thread) with
// a carried base, so each survivor is written straight to its rank and the
// output stays in ascending flat-lane order.
#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kCompactThreads = 1024;
constexpr int kCompactItems = 8;

// Run by every thread of one block of kCompactThreads threads.  `cum` is
// [B] ints of dynamic shared memory, `scratch` 32.  Writes pt = (P, total),
// kvalid, lane_id; returns P to every thread.
__device__ __forceinline__ int compact_block(
    const uint8_t* __restrict__ en, int B, int G, int K,
    const int32_t* __restrict__ kspread, int32_t* __restrict__ pt,
    int32_t* __restrict__ lane_id, uint8_t* __restrict__ kvalid, int* cum,
    int* scratch) {
  const int T = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. Per-parent fan-out, one warp per parent row.
  for (int b = warp; b < B; b += T >> 5) {
    const uint8_t* row = en + (size_t)b * G;
    int c = 0;
    for (int g = lane; g < G; g += 32) c += row[g] != 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) cum[b] = c;
  }
  __syncthreads();

  // 2. Inclusive cumsum of the fan-outs (contiguous chunk per thread).
  const int per = (B + T - 1) / T;
  const int b0 = min((int)threadIdx.x * per, B), b1 = min(b0 + per, B);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += cum[b];
  int unused;
  int run = block_exclusive_scan(local, &unused, scratch);
  for (int b = b0; b < b1; ++b) {
    run += cum[b];
    cum[b] = run;
  }
  __syncthreads();

  // 3. Progress limiting: P = #{b : cum[b] <= K} (cum is non-decreasing).
  int fits = 0;
  for (int b = b0; b < b1; ++b) fits += cum[b] <= K;
  int P;
  block_exclusive_scan(fits, &P, scratch);
  const int total = P > 0 ? cum[P - 1] : 0;
  if (threadIdx.x == 0) {
    pt[0] = P;
    pt[1] = total;
  }
  for (int k = threadIdx.x; k < K; k += T) {
    kvalid[k] = k < total;
    if (k >= total) lane_id[k] = kspread[k];
  }

  // 4. Survivors of the first P parents, in ascending flat-lane order.
  const int F = P * G;
  int carry = 0;
  for (int t0 = 0; t0 < F; t0 += T * kCompactItems) {
    const int f0 = t0 + threadIdx.x * kCompactItems;
    uint32_t bits = 0;
    int c = 0;
#pragma unroll
    for (int q = 0; q < kCompactItems; ++q) {
      const int f = f0 + q;
      if (f < F && en[f]) {
        bits |= 1u << q;
        ++c;
      }
    }
    int tile_total;
    int pos = carry + block_exclusive_scan(c, &tile_total, scratch);
#pragma unroll
    for (int q = 0; q < kCompactItems; ++q)
      if ((bits >> q) & 1u) lane_id[pos++] = f0 + q;
    carry += tile_total;
  }
  return P;
}

}  // namespace rtt
