// Lane compaction for the v3 chunk: a multi-block scan in place of a
// sequential scan.
//
// Replaces raft_tla_tpu/ops/compact_pallas.py `_kernel` (reached through
// `_compact_jit`), which walks all B*G flat lanes one at a time in a
// `fori_loop` because a TPU grid runs in order.  Two launches on one
// stream, no host round trip:
//
//   1. count_kernel: a warp a row writes the row's fan-out to counts[B],
//      reading the row's flags as 32-bit words when rows are 4-byte
//      aligned (G = 132 on the main path), as bytes otherwise;
//   2. compact_scan_kernel (compact.cuh, shared with the v4 front): a grid
//      of 16-row blocks, each scanning all B counts itself and writing its
//      own rows' lane ids.
//
// Bound on the H100: bytes.  It reads the [B, G] mask once (270 KB at the
// main path's B = 2048, G = 132) and writes K lane ids and K flags (160
// KB): about 0.15 us at 3.35 TB/s.  Both launches are a few L2 round trips
// deep (128 blocks of the second at B = 2048), so launch and latency, not
// bytes, set their time.

#include "compact.cuh"

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountRows = kCountThreads / 32;  // a warp a row

__global__ void __launch_bounds__(kCountThreads)
count_kernel(const uint8_t* __restrict__ en, int B, int G, int words,
             int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCountRows + (threadIdx.x >> 5);
  if (b >= B) return;
  const uint8_t* row = en + (size_t)b * G;
  int c = 0;
  if (words) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    for (int i = lane; i < G / 4; i += 32) c += __popc(__vsetne4(w[i], 0u));
  } else {
    for (int g = lane; g < G; g += 32) c += row[g] != 0;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) counts[b] = c;
}

int count_blocks(int B) { return (B + kCountRows - 1) / kCountRows; }

}  // namespace

extern "C" int compact_launch(const void* en, int B, int G, int K,
                              const void* kspread, void* counts, void* pt,
                              void* lane_id, void* kvalid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int words = G % 4 == 0 && (uintptr_t)en % 4 == 0;
  count_kernel<<<count_blocks(B), kCountThreads, 0, st>>>(
      (const uint8_t*)en, B, G, words, (int32_t*)counts);
  int e = (int)cudaGetLastError();
  if (e) return e;
  rtt::compact_scan_kernel<<<rtt::scan_blocks(B), rtt::kScanThreads, 0,
                             st>>>(
      (const uint8_t*)en, (const int32_t*)counts, B, G, K,
      (const int32_t*)kspread, (int32_t*)pt, (int32_t*)lane_id,
      (uint8_t*)kvalid, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// Launch `which` of one compact call (0 counts, 1 scan and write) for
// chip_smoke.py.
extern "C" int compact_kernel_info(int which, int B, int G, int K, int* out) {
  (void)G;
  (void)K;
  if (which == 0)
    return rtt::kernel_info(count_kernel, count_blocks(B), kCountThreads, 0,
                            out);
  if (which == 1)
    return rtt::kernel_info(rtt::compact_scan_kernel, rtt::scan_blocks(B),
                            rtt::kScanThreads, 0, out);
  return (int)cudaErrorInvalidValue;
}
