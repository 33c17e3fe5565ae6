// Seen-set probe/insert shared by csrc/fpset.cu and csrc/fused_tail.cu.
//
// The table is one array of C = 2^k packed keys (hi << 32) | lo; the
// all-ones key is the empty slot.  A key's probe chain is the JAX
// package's (ops/fpset.py _probe_base): slot_r = (h1 + r * h2) & (C - 1),
// advancing only past slots held by a different key, at most 32 probes.
//
// The TPU kernel inserts its queries one after another, so `is_new` lands
// on the lowest lane holding each new key.  Here every lane probes at once
// and ownership is settled in three launches, each a programmatic
// dependent of the one before, so their launch latencies overlap:
//
//   1. probe/claim: each valid lane walks its chain with a 64-bit
//      atomicCAS(EMPTY -> key).  The CAS winner writes its lane into the
//      slot's owner word; a lane that reads its own key stops there.
//      Slot contents are read L1-bypassing (ld.relaxed.gpu), two probes
//      of the chain at a time: both addresses are known from (h1, h2), so
//      the slowest lane's chain of dependent reads is halved.  A valid
//      lane unresolved after 32 probes marks its slot word kSlotFailed.
//      Block 0 zeroes `fail`.
//   2. own: every lane whose slot was claimed in this call (owner word
//      set) takes atomicMin(owner, lane) -> the lowest lane of that key.
//   3. resolve: a lane is new iff the owner word holds its own lane; the
//      owner lane resets the word, so the owner array is all NO_OWNER
//      again after every call (only slots claimed in this call were
//      touched, and each has its claiming lane resolving to it).  A block
//      adds its new lanes to the size, writes `fail` if one of its lanes
//      failed, and, for the fused tail, the count of `is_new & enq_ok` in
//      each 64-lane tile.
//
// Slots never return to empty, so a lane that passes a slot held by
// another key can never see that slot claimed for its own key later: two
// lanes of one key walk the same chain and meet at one slot.  The raw slot
// a key lands in may differ from the sequential kernel's.  When no query
// fails, the stored key set, `is_new` and the size are the sequential
// kernel's.  Near a full chain the different layout can make a different
// query fail (or one fail where none did), so `fail` itself may differ;
// the engine stops on `fail` either way.
//
// chip_smoke.py --tail-variants builds the designs this one was measured
// against (source substitutions of this file; PERF.md has the table).

#pragma once

#include "common.cuh"

namespace rtt {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kProbeRounds = 32;     // ops/fpset.py PROBE_ROUNDS
constexpr int kNoOwner = 0x7fffffff;
constexpr int kInsertThreads = 256;
constexpr int kSlotInvalid = -1;     // slot word of a lane not queried
constexpr int kSlotFailed = -2;      // ... of a valid lane with no slot
constexpr int kTailTile = 64;        // lanes of one enqueue tile (2 warps)
static_assert(kProbeRounds % 2 == 0 && kInsertThreads % kTailTile == 0 &&
                  kTailTile == 64,
              "probe pairs and two-warp tiles");

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void probe_base(unsigned long long key,
                                           uint32_t cmask, uint32_t* h1,
                                           uint32_t* h2) {
  const uint32_t qhi = (uint32_t)(key >> 32), qlo = (uint32_t)key;
  *h1 = fmix32(qhi ^ fmix32(qlo ^ 0x9E3779B9u)) & cmask;
  *h2 = fmix32(qlo ^ fmix32(qhi ^ 0x85EBCA6Bu)) | 1u;
}

// The probe of slot `idx`, read as `cur` (possibly before the chain's
// earlier probe resolved: a slot once written never changes, and a stale
// empty is settled by the CAS).  True when the lane's chain ends here.
__device__ __forceinline__ bool probe_slot(uint32_t idx,
                                           unsigned long long cur,
                                           unsigned long long key, int l,
                                           unsigned long long* table,
                                           int* owner, int* slot) {
  if (cur == kEmpty) {
    cur = atomicCAS(&table[idx], kEmpty, key);
    if (cur == kEmpty) {
      owner[idx] = l;
      *slot = (int)idx;
      return true;
    }
  }
  if (cur == key) *slot = (int)idx;
  return cur == key;
}

// The chain of `key`: its slot, or kSlotFailed after kProbeRounds probes.
__device__ __forceinline__ int claim(unsigned long long key, int l,
                                     unsigned long long* table,
                                     uint32_t cmask, int* owner) {
  uint32_t h1, h2;
  probe_base(key, cmask, &h1, &h2);
  int slot = kSlotFailed;
  for (uint32_t r = 0; r < kProbeRounds; r += 2) {
    const uint32_t i0 = (h1 + r * h2) & cmask;
    const uint32_t i1 = (h1 + (r + 1) * h2) & cmask;
    const unsigned long long c0 = ld_relaxed(&table[i0]);
    const unsigned long long c1 = ld_relaxed(&table[i1]);
    if (probe_slot(i0, c0, key, l, table, owner, &slot)) break;
    if (probe_slot(i1, c1, key, l, table, owner, &slot)) break;
  }
  return slot;
}

// Pass 1 for the lane l.
__device__ __forceinline__ void claim_lane(
    int l, int n, const unsigned long long* __restrict__ q,
    const uint8_t* __restrict__ valid, unsigned long long* table,
    uint32_t cmask, int* owner, int* __restrict__ slot_out) {
  int slot = kSlotInvalid;
  if (l < n && valid[l]) slot = claim(q[l], l, table, cmask, owner);
  if (l < n) slot_out[l] = slot;
}

// Pass 3 for the block's lanes l0 .. l0 + kInsertThreads (every thread of
// the block calls it; `smem` holds kInsertThreads / 32 ints).
template <bool kTiles>
__device__ __forceinline__ void resolve_block(
    int l0, int n, const int* slot, int* owner, uint8_t* __restrict__ is_new,
    unsigned long long* size, uint8_t* fail,
    const uint8_t* __restrict__ enq_ok, int* __restrict__ tile_count,
    int* smem) {
  const int l = l0 + (int)threadIdx.x;
  bool nw = false, bad = false;
  if (l < n) {
    const int s = slot[l];
    bad = s == kSlotFailed;
    if (s >= 0 && owner[s] == l) {
      nw = true;
      owner[s] = kNoOwner;
    }
    is_new[l] = nw;
  }
  const int c = __syncthreads_count(nw);
  const int f = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (c) atomicAdd(size, (unsigned long long)c);
    if (f) *fail = 1;
  }
  if (kTiles) {
    const unsigned b = __ballot_sync(0xffffffffu, nw && enq_ok[l]);
    if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = __popc(b);
    __syncthreads();
    if (threadIdx.x < kInsertThreads / kTailTile) {
      const int t = l0 / kTailTile + (int)threadIdx.x;
      if (t * kTailTile < n)
        tile_count[t] = smem[2 * threadIdx.x] + smem[2 * threadIdx.x + 1];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kInsertThreads)
probe_claim_kernel(const unsigned long long* __restrict__ q,
                   const uint8_t* __restrict__ valid, int n,
                   unsigned long long* table, uint32_t cmask, int* owner,
                   int* __restrict__ slot_out, uint8_t* fail) {
  launch_dependents();
  if (blockIdx.x == 0 && threadIdx.x == 0) *fail = 0;
  claim_lane(blockIdx.x * kInsertThreads + threadIdx.x, n, q, valid, table,
             cmask, owner, slot_out);
}

__global__ void __launch_bounds__(kInsertThreads)
own_kernel(const int* slot, int n, int* owner) {
  grid_dependency_wait();
  launch_dependents();
  const int l = blockIdx.x * kInsertThreads + threadIdx.x;
  if (l >= n) return;
  const int s = slot[l];
  if (s >= 0 && owner[s] != kNoOwner) atomicMin(&owner[s], l);
}

template <bool kTiles>
__global__ void __launch_bounds__(kInsertThreads)
resolve_kernel(const int* slot, int n, int* owner,
               uint8_t* __restrict__ is_new, unsigned long long* size,
               uint8_t* fail, const uint8_t* __restrict__ enq_ok,
               int* __restrict__ tile_count) {
  __shared__ int smem[kInsertThreads / 32];
  grid_dependency_wait();
  launch_dependents();
  resolve_block<kTiles>(blockIdx.x * kInsertThreads, n, slot, owner, is_new,
                        size, fail, enq_ok, tile_count, smem);
}

// Blocks of one insert pass: a lane a thread, at least one block (block 0
// zeroes `fail` even when n is 0).
inline int insert_blocks(int n) {
  return n > 0 ? (n + kInsertThreads - 1) / kInsertThreads : 1;
}

// The insert passes on `stream`; with `tile_count` (fused tail) pass 3
// also writes the per-tile counts of is_new & enq_ok.  Returns the first
// launch error.
static inline cudaError_t launch_insert(const void* q, const void* valid,
                                        int n, void* table,
                                        long long capacity, void* owner,
                                        void* slot, void* is_new, void* size,
                                        void* fail, const void* enq_ok,
                                        void* tile_count,
                                        cudaStream_t stream) {
  const uint32_t cmask = (uint32_t)(capacity - 1);
  auto qp = (const unsigned long long*)q;
  auto vp = (const uint8_t*)valid;
  auto tp = (unsigned long long*)table;
  auto op = (int*)owner;
  auto sp = (int*)slot;
  auto np = (uint8_t*)is_new;
  auto zp = (unsigned long long*)size;
  auto fp = (uint8_t*)fail;
  auto ep = (const uint8_t*)enq_ok;
  auto cp = (int*)tile_count;
  const int blocks = insert_blocks(n);
  cudaError_t e = launch(probe_claim_kernel, blocks, kInsertThreads, stream,
                         false, qp, vp, n, tp, cmask, op, sp, fp);
  if (e != cudaSuccess) return e;
  e = launch(own_kernel, blocks, kInsertThreads, stream, true,
             (const int*)sp, n, op);
  if (e != cudaSuccess) return e;
  return launch(tile_count ? resolve_kernel<true> : resolve_kernel<false>,
                blocks, kInsertThreads, stream, true, (const int*)sp, n, op,
                np, zp, fp, ep, cp);
}

}  // namespace rtt
