// Fused seen-set insert -> enqueue for the chunk tail.
//
// Replaces raft_tla_tpu/ops/fused_tail_pallas.py `_kernel` (reached
// through `_tail_padded`), which probes each query in lane order and, the
// moment it resolves as new, DMAs its row to the running enqueue cursor.
// Here four launches on one stream, each a programmatic dependent of the
// one before (no host round trip, no other device operation):
//
//   1-3. probe/claim, own and resolve: fpset.cuh's insert passes (the same
//      device code as csrc/fpset.cu); resolve also writes, for each tile of
//      64 lanes, how many of its lanes have is_new & enq_ok;
//   4. enqueue_tiles_kernel<false> (enqueue.cuh, also the split tail's
//      tile launch): a block per 64-lane tile reads its flags as a mask,
//      copies the rows of each run of enqueued lanes into shared memory
//      with one bulk copy, sums the counts of the tiles before it and
//      writes its rows as one contiguous span of the queue, 16 bytes at a
//      time.  The block of the last tile writes the new count.
//
// When no query fails, live rows, is_new and the new count match the TPU
// kernel (fpset.cuh says how far fail does); its per-lane trash writes are
// not part of the contract and are not made: rows at and past the new
// count are left as they were.
//
// Bound on the H100: bytes.  The work reads the K keys and flags, one
// probe sector per distinct key, and only the rows it enqueues, and writes
// those rows: at K = 32,768 lanes with ~7,600 enqueued 473-byte rows about
// 7 MB, about 2 us at 3.35 TB/s.  The first design took 58 us queued at the
// phase's shapes: its scan was one block of 1,024 threads on one of 132
// SMs, reading flags a byte a thread 8 bytes apart (31 us, where its note
// expected a few), then a warp per lane over all K lanes copied a row a
// byte per thread (8 us), after a fill, three insert launches and a
// comparison.  Here the scan is spread over 512 blocks with no dependency
// between them, the copy moves 16-byte words, and the fill and the
// comparison are gone; what is left is the probe's chain of dependent
// reads, the row copy's round trip to memory and four launch latencies,
// which the programmatic dependency overlaps.

#include "enqueue.cuh"
#include "fpset.cuh"

static_assert(rtt::kCopyTile == rtt::kTailTile,
              "resolve counts the tiles of the copy");

extern "C" int fused_tail_launch(const void* q, const void* valid,
                                 const void* enq_ok, int n, void* table,
                                 long long capacity, void* owner, void* slot,
                                 void* is_new, void* size, void* fail,
                                 void* tile_count, const void* krows, int sw,
                                 void* qnext, const void* next_count,
                                 void* count_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = rtt::launch_insert(q, valid, n, table, capacity, owner,
                                     slot, is_new, size, fail, enq_ok,
                                     tile_count, s);
  if (e != cudaSuccess) return (int)e;
  return (int)rtt::launch(
      rtt::enqueue_tiles_kernel<false>, rtt::copy_tiles(n),
      rtt::kCopyThreads, s, true, (const uint8_t*)is_new,
      (const uint8_t*)enq_ok, (const int*)tile_count, n,
      (const uint8_t*)krows, sw, (uint8_t*)qnext, (const int*)next_count,
      (int*)count_out);
}

// Launch `which` of one fused tail of n lanes (0 probe/claim, 1 own, 2
// resolve, 3 the tiles' scan and copy) for chip_smoke.py.
extern "C" int fused_tail_kernel_info(int which, int n, int* out) {
  const int blocks = rtt::insert_blocks(n);
  if (which == 0)
    return rtt::kernel_info(rtt::probe_claim_kernel, blocks,
                            rtt::kInsertThreads, 0, out);
  if (which == 1)
    return rtt::kernel_info(rtt::own_kernel, blocks, rtt::kInsertThreads, 0,
                            out);
  if (which == 2)
    return rtt::kernel_info(rtt::resolve_kernel<true>, blocks,
                            rtt::kInsertThreads, 0, out);
  if (which == 3)
    return rtt::kernel_info(rtt::enqueue_tiles_kernel<false>,
                            rtt::copy_tiles(n), rtt::kCopyThreads, 0, out);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry the wrapper sizes its scratch and checks rows by:
// out[0] = lanes of a tile (ints of the per-tile count scratch: one a
// tile), out[1] = the widest row the stage takes (one row a turn after a
// 16-byte lead).
extern "C" void fused_tail_geometry(int* out) {
  out[0] = rtt::kTailTile;
  out[1] = rtt::kWidestRow;
}
