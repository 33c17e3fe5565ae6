// Enqueue of the split chunk tail: append the rows of the enq lanes, in
// lane order, to the next-level queue.
//
// Replaces raft_tla_tpu/ops/enqueue_pallas.py `_kernel` (reached through
// `_enqueue_jit`, with its copy plan from `build_copy_plan`).  The TPU
// kernel is one sequential loop of 8-row HBM-to-HBM DMAs over a plan that
// cummax/cumsum/searchsorted build outside it, because a DMA's size must
// be static there and the grid runs in order.  None of that is carried
// over.  Here one launch does the whole append, with no plan, no scratch
// in device memory and no dependency between blocks:
//
//   1. a block of 256 threads owns a tile of 64 lanes.  It counts the enq
//      flags of all lanes before its tile itself (16 bytes a thread a
//      step, out of L2: at K = 32,768 that is at most 32 KB a block), so
//      no block waits for another and the result does not depend on the
//      order they run;
//   2. it scans its own 64 flags (common.cuh's block scan) and lists its
//      enq lanes by rank in shared memory;
//   3. its 8 warps take those rows in turn, a warp a row: row r of the
//      tile goes to qnext[next_count + before + r].  Rows are sw = 473
//      bytes, so neither source nor destination is 4-byte aligned: the
//      warp peels the destination's unaligned head and tail as bytes and
//      writes the middle as 32-bit words put together from byte loads
//      (a word load of the source could leave the row, and the tensor);
//   4. the block of the last tile writes count = next_count + all flags.
//
// Rows at and past the new count are left as they were (the TPU kernel's
// overhang writes are not part of the contract).  Byte offsets are 64-bit:
// (2^21 + 32,768) rows of 473 bytes just fit 31 bits, a larger queue does
// not.  The copy is bound by latency, not by bandwidth (a row is a handful
// of dependent round trips to memory), so a tile is small: 64 lanes give
// 512 blocks and 4,096 warps at K = 32,768, one or two rows a warp at the
// main path's fill.  With a tile of 256 lanes the same kernel took about
// twice as long, with 32 a little longer again.
//
// Bound on the H100: bytes.  The work reads the K flags and reads and
// writes only the enqueued rows: at K = 32,768 with ~7,600 rows (a full
// batch at depth 8) about 7.2 MB, 2.1 us at 3.35 TB/s.  What this design leaves on the table: a
// tile's destination is ONE contiguous byte span (the point of the TPU
// kernel), so whole runs of adjacent enq lanes could move as 16-byte
// vector copies through shared memory, or as TMA bulk copies, instead of
// row by row; and the redundant prefix count grows with K^2 / 64, which
// a decoupled look-back scan would replace for K far above this path's.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // lanes a block owns; a multiple of 16

__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ out, int sw,
                                         int lane) {
  const int head = min(sw, (int)((4 - ((uintptr_t)out & 3)) & 3));
  if (lane < head) out[lane] = src[lane];
  const int words = (sw - head) >> 2;
  const uint8_t* s = src + head;
  uint32_t* o = (uint32_t*)(out + head);
#pragma unroll 4
  for (int w = lane; w < words; w += 32) {
    const uint8_t* p = s + 4 * w;
    o[w] = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
  }
  const int done = head + 4 * words;
  if (lane < sw - done) out[done + lane] = src[done + lane];
}

// `enq` is 16-byte aligned (the wrapper sees to it); flags are bytes, any
// non-zero byte set.
__global__ void __launch_bounds__(kThreads)
enqueue_kernel(const uint8_t* __restrict__ enq, int n,
               const uint8_t* __restrict__ krows, int sw,
               uint8_t* __restrict__ qnext, long long next_count,
               int* __restrict__ count_out) {
  __shared__ int scratch[32];
  __shared__ int src_lane[kTile];
  const int t0 = blockIdx.x * kTile;

  // 1. enq lanes before this tile (t0 is a multiple of 16).
  int mine = 0;
  const uint4* v = (const uint4*)enq;
  for (int i = threadIdx.x; i < t0 / 16; i += kThreads) {
    const uint4 w = v[i];
    mine += __popc(__vsetne4(w.x, 0u)) + __popc(__vsetne4(w.y, 0u)) +
            __popc(__vsetne4(w.z, 0u)) + __popc(__vsetne4(w.w, 0u));
  }
  int before;
  rtt::block_exclusive_scan(mine, &before, scratch);

  // 2. Ranks inside the tile.
  const int l = t0 + threadIdx.x;
  const int flag = (threadIdx.x < kTile && l < n && enq[l]) ? 1 : 0;
  int tile_total;
  const int rank = rtt::block_exclusive_scan(flag, &tile_total, scratch);
  if (flag) src_lane[rank] = l;
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1)
    count_out[0] = (int)(next_count + before + tile_total);

  // 3. A warp a row, rows in turn.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t first = (size_t)(next_count + before);
  for (int r = warp; r < tile_total; r += kWarps)
    copy_row(krows + (size_t)src_lane[r] * sw, qnext + (first + r) * sw, sw,
             lane);
}

}  // namespace

extern "C" int enqueue_launch(const void* enq, int n, const void* krows,
                              int sw, void* qnext, long long next_count,
                              void* count_out, void* stream) {
  const int blocks = n > 0 ? (n + kTile - 1) / kTile : 1;
  enqueue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)enq, n, (const uint8_t*)krows, sw, (uint8_t*)qnext,
      next_count, (int*)count_out);
  return (int)cudaGetLastError();
}
