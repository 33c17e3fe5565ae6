// Fused seen-set insert -> enqueue for the v3 chunk tail.
//
// Replaces raft_tla_tpu/ops/fused_tail_pallas.py `_kernel` (reached
// through `_tail_padded`), which probes each query in lane order and, the
// moment it resolves as new, DMAs its row to the running enqueue cursor.
// Here the insert is fpset.cuh's three parallel passes (the same probe
// device code as csrc/fpset.cu), then
//
//   4. scan: one block of 1024 threads walks the K lanes in tiles of
//      8 per thread and gives every lane with is_new & enq_ok its rank in
//      lane order, dst = next_count + rank (-1 for the rest), and the new
//      count;
//   5. copy: one warp per lane copies an enqueued 473-byte row from the
//      compacted rows to qnext[dst] (rows are neither 4- nor 16-byte
//      aligned, so the warp copies bytes, consecutive threads on
//      consecutive bytes).
//
// When no query fails, live rows, is_new and the new count match the TPU
// kernel (fpset.cuh says how far fail does); its per-lane trash writes are
// not part of the contract and are not made.
//
// Bound on the H100: bytes.  The work reads the K keys and flags, one
// probe sector per distinct key, and only the rows it enqueues, and writes
// those rows: at K = 32,768 lanes with ~5,000 enqueued 473-byte rows about
// 6 MB, under 2 us at 3.35 TB/s.  The design reads only the rows it
// enqueues and keeps the scan to one block (K flags fit one block's loop
// in a few microseconds); the byte copy is the part to widen first if this
// kernel shows up in the profile.

#include "fpset.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kItems = 8;
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
enqueue_scan_kernel(const uint8_t* __restrict__ is_new,
                    const uint8_t* __restrict__ enq_ok, int n,
                    int next_count, int* __restrict__ dst,
                    int* __restrict__ count_out) {
  __shared__ int scratch[32];
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += kScanThreads * kItems) {
    const int l0 = t0 + threadIdx.x * kItems;
    uint32_t bits = 0;
    int c = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int l = l0 + q;
      if (l < n && is_new[l] && enq_ok[l]) {
        bits |= 1u << q;
        ++c;
      }
    }
    int tile_total;
    int pos = next_count + carry +
              rtt::block_exclusive_scan(c, &tile_total, scratch);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int l = l0 + q;
      if (l < n) dst[l] = ((bits >> q) & 1u) ? pos++ : -1;
    }
    carry += tile_total;
  }
  if (threadIdx.x == 0) count_out[0] = next_count + carry;
}

__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const uint8_t* __restrict__ krows, int sw,
                 const int* __restrict__ dst, int n,
                 uint8_t* __restrict__ qnext) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int d = dst[row];
  if (d < 0) return;
  const uint8_t* src = krows + (size_t)row * sw;
  uint8_t* out = qnext + (size_t)d * sw;
  for (int j = lane; j < sw; j += 32) out[j] = src[j];
}

}  // namespace

extern "C" int fused_tail_launch(const void* q, const void* valid,
                                 const void* enq_ok, int n, void* table,
                                 long long capacity, void* owner, void* slot,
                                 void* is_new, void* size, void* fail,
                                 const void* krows, int sw, void* qnext,
                                 int next_count, void* dst, void* count_out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = rtt::launch_insert(q, valid, n, table, capacity, owner,
                                     slot, is_new, size, fail, s);
  if (e != cudaSuccess) return (int)e;
  enqueue_scan_kernel<<<1, kScanThreads, 0, s>>>(
      (const uint8_t*)is_new, (const uint8_t*)enq_ok, n, next_count,
      (int*)dst, (int*)count_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long threads = (long long)n * 32;
  const int blocks = (int)((threads + kCopyThreads - 1) / kCopyThreads);
  if (blocks > 0)
    copy_rows_kernel<<<blocks, kCopyThreads, 0, s>>>(
        (const uint8_t*)krows, sw, (const int*)dst, n, (uint8_t*)qnext);
  return (int)cudaGetLastError();
}
