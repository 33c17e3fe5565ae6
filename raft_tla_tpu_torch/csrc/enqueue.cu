// Enqueue of the split chunk tail: append the rows of the enq lanes, in
// lane order, to the next-level queue.
//
// Replaces raft_tla_tpu/ops/enqueue_pallas.py `_kernel` (reached through
// `_enqueue_jit`, with its copy plan from `build_copy_plan`).  The TPU
// kernel is one sequential loop of 8-row HBM-to-HBM DMAs over a plan that
// cummax/cumsum/searchsorted build outside it, because a DMA's size must
// be static there and the grid runs in order.  None of that is carried
// over.  Here two launches on one stream, each a programmatic dependent
// of the launch before it:
//
//   1. enqueue_count_kernel: four threads a 64-lane tile, a 16-byte load
//      of flags each and __popc, write one count a tile (the flags past n
//      read as bytes);
//   2. enqueue_tiles_kernel<true> (enqueue.cuh, the fused tail's tile
//      launch): a block per tile reads its flags and starts the bulk
//      copies of its rows into shared memory before it waits for the
//      counts (what it reads there is older than launch 1), sums the
//      counts before its tile while the copies fly, and stores its rows
//      as one span with 16-byte stores.  The block of the last tile writes
//      count = next_count + all flags.
//
// Rows at and past the new count are left as they were (the TPU kernel's
// overhang writes are not part of the contract).  `enq` is 16-byte aligned
// (the wrapper sees to it).
//
// Bound on the H100: bytes.  The work reads the K flags and reads and
// writes only the enqueued rows: at K = 32,768 with ~7,600 rows of 473
// bytes (a full batch at depth 8) about 7.2 MB, 2.1 us at 3.35 TB/s; on
// the full mask about 31 MB, 9.3 us.  The first design, one launch in
// which every block re-counted all flags before its tile (K^2 / 64 flag
// reads) and a warp copied a row at a time in 32-bit words, took 8.5-8.8
// us a call queued on a depth-8 batch and 17.6-18.9 on the full mask;
// chip_smoke.py --enqueue-variants measures it and the other designs
// against this one (PERF.md has the table).

#include "enqueue.cuh"

namespace {

constexpr int kCountThreads = 256;  // 64 tiles a block

__global__ void __launch_bounds__(kCountThreads)
enqueue_count_kernel(const uint8_t* enq, int n, int tiles,
                     int* __restrict__ tile_count) {
  // This launch is itself a programmatic dependent of whatever ran before
  // it on the stream (its launch overlaps that kernel's end), so it reads
  // the flags only after the wait, from L2 (common.cuh says why `enq` is
  // no __restrict__ pointer).  The tile launch may then take the card's
  // free slots at once: what it reads before its own wait (flags, rows)
  // is complete by now, and the counts it reads after it.
  rtt::grid_dependency_wait();
  rtt::launch_dependents();
  const int g = blockIdx.x * kCountThreads + threadIdx.x;  // 16 flags
  const int l0 = 16 * g;
  int c = 0;
  if (l0 + 16 <= n) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(enq) + g);
    c = __popc(__vsetne4(w.x, 0u)) + __popc(__vsetne4(w.y, 0u)) +
        __popc(__vsetne4(w.z, 0u)) + __popc(__vsetne4(w.w, 0u));
  } else {
    for (int l = l0; l < n; ++l) c += __ldcg(enq + l) != 0;
  }
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  if ((g & 3) == 0 && (g >> 2) < tiles) tile_count[g >> 2] = c;
}

int count_blocks(int tiles) {
  return (4 * tiles + kCountThreads - 1) / kCountThreads;
}

}  // namespace

extern "C" int enqueue_launch(const void* enq, int n, const void* krows,
                              int sw, void* qnext, const void* next_count,
                              void* tile_count, void* count_out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = rtt::copy_tiles(n);
  cudaError_t e = rtt::launch(enqueue_count_kernel, count_blocks(tiles),
                              kCountThreads, s, true, (const uint8_t*)enq,
                              n, tiles, (int*)tile_count);
  if (e != cudaSuccess) return (int)e;
  return (int)rtt::launch(
      rtt::enqueue_tiles_kernel<true>, tiles, rtt::kCopyThreads, s, true,
      (const uint8_t*)enq, (const uint8_t*)nullptr, (const int*)tile_count,
      n, (const uint8_t*)krows, sw, (uint8_t*)qnext, (const int*)next_count,
      (int*)count_out);
}

// Launch `which` of one enqueue of n lanes (0 the counts, 1 the tiles) for
// chip_smoke.py.
extern "C" int enqueue_kernel_info(int which, int n, int* out) {
  const int tiles = rtt::copy_tiles(n);
  if (which == 0)
    return rtt::kernel_info(enqueue_count_kernel, count_blocks(tiles),
                            kCountThreads, 0, out);
  if (which == 1)
    return rtt::kernel_info(rtt::enqueue_tiles_kernel<true>, tiles,
                            rtt::kCopyThreads, 0, out);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry the wrapper sizes its scratch and checks rows by:
// out[0] = lanes of a tile (the count scratch holds one int a tile),
// out[1] = the widest row the stage takes (one row a turn).
extern "C" void enqueue_geometry(int* out) {
  out[0] = rtt::kCopyTile;
  out[1] = rtt::kWidestRow;
}
