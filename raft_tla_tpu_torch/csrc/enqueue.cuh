// Tile-wise append of rows to the next-level queue, in lane order: the
// fused tail's copy (csrc/fused_tail.cu), kept in a header of its own for
// the split tail's B5 (csrc/enqueue.cu), whose copy is the next to move
// onto it.
//
// A block of kCopyThreads owns a tile of lanes (64 in the fused tail,
// fpset.cuh kTailTile).  Its enqueued lanes land in ONE contiguous byte
// span of the queue, starting at row next_count + (enqueued lanes of the
// tiles before it).  The block
//
//   1. sums the tile counts before its tile (written by the insert's
//      resolve pass: one int a tile, read 16 bytes a thread a step, so
//      the redundant work is K / 64 ints a block, not K flags);
//   2. ranks its own lanes with a block scan and lists the enqueued ones;
//   3. gathers those rows into shared memory, a warp a row, laid out as
//      the destination span is, aligned words read from the source row
//      (bytes only at its unaligned ends, so nothing outside the row is
//      read);
//   4. writes the span with 16-byte stores, peeling its unaligned head and
//      tail as bytes.  Rows are 473 bytes on the main path, 473 = 9 (mod
//      16), so a destination row is 16-byte aligned only by chance; the
//      span as a whole is written at full width regardless.
//
// A tile whose rows outgrow the stage (rows above kStageBytes / 64 bytes)
// is staged in turns.  Byte offsets into the queue are 64-bit: (2^21 +
// 32,768) rows of 473 bytes just fit 31 bits, a larger queue does not.

#pragma once

#include "common.cuh"

namespace rtt {

constexpr int kCopyThreads = 256;
constexpr int kCopyWarps = kCopyThreads / 32;
constexpr int kStageBytes = 30720;  // 64 rows of 473 bytes and a 16-byte lead

// Sum of counts[0 .. t) by the whole block (counts 16-byte aligned).
__device__ __forceinline__ int sum_before(const int* __restrict__ counts,
                                          int t, int* smem) {
  int mine = 0;
  const int4* v = reinterpret_cast<const int4*>(counts);
  for (int i = threadIdx.x; i < t / 4; i += kCopyThreads) {
    const int4 w = v[i];
    mine += w.x + w.y + w.z + w.w;
  }
  if ((int)threadIdx.x < t % 4) mine += counts[(t & ~3) + threadIdx.x];
  int total;
  block_exclusive_scan(mine, &total, smem);
  return total;
}

// `sw` bytes from the global row `src` to the shared row `out`, by one
// warp: 32-bit loads of the words inside the row, bytes at its ends, all
// of a row's loads issued before its stores (one round trip to memory for
// rows up to 512 bytes).
__device__ __forceinline__ void gather_row(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ out, int sw,
                                           int lane) {
  const int head = min(sw, (int)((4 - ((uintptr_t)src & 3)) & 3));
  const int words = (sw - head) >> 2;
  const int done = head + 4 * words;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(src + head);
  uint8_t* o = out + head;
  const uint8_t hb = lane < head ? src[lane] : 0;
  const uint8_t tb = lane < sw - done ? src[done + lane] : 0;
  for (int i0 = 0; i0 < words; i0 += 4 * 32) {
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 32 * k + lane;
      x[k] = i < words ? w[i] : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 32 * k + lane;
      if (i < words) {
        o[4 * i] = (uint8_t)x[k];
        o[4 * i + 1] = (uint8_t)(x[k] >> 8);
        o[4 * i + 2] = (uint8_t)(x[k] >> 16);
        o[4 * i + 3] = (uint8_t)(x[k] >> 24);
      }
    }
  }
  if (lane < head) out[lane] = hb;
  if (lane < sw - done) out[done + lane] = tb;
}

// `len` bytes staged at stage + lead to `dst` (lead = dst's offset in its
// 16-byte line), by the whole block.
__device__ __forceinline__ void store_span(const uint8_t* stage, int lead,
                                           uint8_t* __restrict__ dst,
                                           int len) {
  const int t = threadIdx.x;
  const int head = min(len, (16 - lead) & 15);
  if (t < head) dst[t] = stage[lead + t];
  const int vecs = (len - head) >> 4;
  const uint4* s = reinterpret_cast<const uint4*>(stage + lead + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = t; i < vecs; i += kCopyThreads) d[i] = s[i];
  const int done = head + 16 * vecs;
  if (t < len - done) dst[done + t] = stage[lead + done + t];
}

// Steps 2-4 for the tile starting at lane t0 whose span starts at queue row
// `first`; `flag` is this thread's lane's enqueue flag (0 for threads past
// the tile).  Returns the tile's enqueued rows.  Every thread calls it.
__device__ __forceinline__ int copy_tile(int flag, int t0,
                                         const uint8_t* __restrict__ krows,
                                         int sw, uint8_t* __restrict__ qnext,
                                         long long first, int* smem,
                                         int* src_lane, uint8_t* stage) {
  int total;
  const int rank = block_exclusive_scan(flag, &total, smem);
  if (flag) src_lane[rank] = t0 + threadIdx.x;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (kStageBytes - 16) / sw;  // rows a turn (>= 1: the
                                            // wrapper checks sw)
  for (int r0 = 0; r0 < total; r0 += per) {
    const int rows = min(per, total - r0);
    uint8_t* dst = qnext + (first + r0) * (long long)sw;
    const int lead = (int)((uintptr_t)dst & 15);
    for (int r = warp; r < rows; r += kCopyWarps)
      gather_row(krows + (size_t)src_lane[r0 + r] * sw,
                 stage + lead + (size_t)r * sw, sw, lane);
    __syncthreads();
    store_span(stage, lead, dst, rows * sw);
    __syncthreads();
  }
  return total;
}

}  // namespace rtt
