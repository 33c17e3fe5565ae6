// Lane compaction for the v3 chunk: a block scan in place of a sequential
// scan.
//
// Replaces raft_tla_tpu/ops/compact_pallas.py `_kernel` (reached through
// `_compact_jit`), which walks all B*G flat lanes one at a time in a
// `fori_loop` because a TPU grid runs in order.  Contract (identical to
// raft_tla_tpu/ops/compact.py build_compactor):
//   per-parent fan-out -> cumsum -> P = longest parent prefix whose fan-out
//   fits K -> total -> kvalid = arange(K) < total -> lane_id = ascending
//   flat indices of the enabled lanes of the first P parents, with
//   kspread in the dead slots.
//
// Bound on the H100: bytes.  It reads the [B, G] mask (270 KB at the main
// path's B=2048, G=132) twice and writes K lane ids and K flags (160 KB):
// about 0.13 us at 3.35 TB/s.  One block cannot approach that rate; the
// design instead keeps everything in one launch with no host round trip:
// a warp per parent counts fan-out, the B counts are scanned in shared
// memory, and the flat flags are scanned tile by tile (8 per thread) with
// a carried base, so each survivor is written straight to its rank and the
// output stays in ascending flat-lane order.  A multi-block decoupled
// look-back scan is the next step if this launch shows up in the profile.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ en, int B, int G, int K,
               const int32_t* __restrict__ kspread, int32_t* __restrict__ pt,
               int32_t* __restrict__ lane_id, uint8_t* __restrict__ kvalid) {
  extern __shared__ int cum[];  // [B] fan-out, then its inclusive cumsum
  __shared__ int scratch[32];
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
  int run = rtt::block_exclusive_scan(local, &unused, scratch);
  for (int b = b0; b < b1; ++b) {
    run += cum[b];
    cum[b] = run;
  }
  __syncthreads();

  // 3. Progress limiting: P = #{b : cum[b] <= K} (cum is non-decreasing).
  int fits = 0;
  for (int b = b0; b < b1; ++b) fits += cum[b] <= K;
  int P;
  rtt::block_exclusive_scan(fits, &P, scratch);
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
  for (int t0 = 0; t0 < F; t0 += T * kItems) {
    const int f0 = t0 + threadIdx.x * kItems;
    uint32_t bits = 0;
    int c = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int f = f0 + q;
      if (f < F && en[f]) {
        bits |= 1u << q;
        ++c;
      }
    }
    int tile_total;
    int pos = carry + rtt::block_exclusive_scan(c, &tile_total, scratch);
#pragma unroll
    for (int q = 0; q < kItems; ++q)
      if ((bits >> q) & 1u) lane_id[pos++] = f0 + q;
    carry += tile_total;
  }
}

}  // namespace

extern "C" int compact_launch(const void* en, int B, int G, int K,
                              const void* kspread, void* pt, void* lane_id,
                              void* kvalid, void* stream) {
  const size_t smem = (size_t)B * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  compact_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)en, B, G, K, (const int32_t*)kspread, (int32_t*)pt,
      (int32_t*)lane_id, (uint8_t*)kvalid);
  return (int)cudaGetLastError();
}
