// Seen-set probe/insert shared by csrc/fpset.cu and csrc/fused_tail.cu.
//
// The table is one array of C = 2^k packed keys (hi << 32) | lo; the
// all-ones key is the empty slot.  A key's probe chain is the JAX
// package's (ops/fpset.py _probe_base): slot_r = (h1 + r * h2) & (C - 1),
// advancing only past slots held by a different key, at most 32 probes.
//
// The TPU kernel inserts its queries one after another, so `is_new` lands
// on the lowest lane holding each new key.  Here every lane probes at once,
// so that ownership is resolved in three passes over the queries:
//
//   1. probe/claim: each valid lane walks its chain with a 64-bit
//      atomicCAS(EMPTY -> key).  The CAS winner writes its lane into the
//      slot's owner word; a lane that reads its own key stops there.  A
//      lane still unresolved after 32 probes raises `fail`.
//   2. own: every lane whose slot was claimed in this call (owner word
//      set) takes atomicMin(owner, lane) -> the lowest lane of that key.
//   3. resolve: a lane is new iff the owner word holds its own lane; the
//      owner lane resets the word, so the owner array is all-empty again
//      between calls (it is touched only at the slots claimed here).
//
// Slots never return to empty, so a lane that passes a slot held by
// another key can never see that slot claimed for its own key later: two
// lanes of one key walk the same chain and meet at one slot.  The raw slot
// a key lands in may differ from the sequential kernel's.  When no query
// fails, the stored key set, `is_new` and the size are the sequential
// kernel's.  Near a full chain the different layout can make a different
// query fail (or one fail where none did), so `fail` itself may differ;
// the engine stops on `fail` either way.

#pragma once

#include "common.cuh"

namespace rtt {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kProbeRounds = 32;     // ops/fpset.py PROBE_ROUNDS
constexpr int kNoOwner = 0x7fffffff;
constexpr int kInsertThreads = 256;

__device__ __forceinline__ void probe_base(unsigned long long key,
                                           uint32_t cmask, uint32_t* h1,
                                           uint32_t* h2) {
  const uint32_t qhi = (uint32_t)(key >> 32), qlo = (uint32_t)key;
  *h1 = fmix32(qhi ^ fmix32(qlo ^ 0x9E3779B9u)) & cmask;
  *h2 = fmix32(qlo ^ fmix32(qhi ^ 0x85EBCA6Bu)) | 1u;
}

__global__ void __launch_bounds__(kInsertThreads)
probe_claim_kernel(const unsigned long long* __restrict__ q,
                   const uint8_t* __restrict__ valid, int n,
                   unsigned long long* table, uint32_t cmask, int* owner,
                   int* __restrict__ slot_out, int* fail) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  int slot = -1;
  if (valid[l]) {
    const unsigned long long key = q[l];
    uint32_t h1, h2;
    probe_base(key, cmask, &h1, &h2);
    uint32_t step = 0;
    for (int r = 0; r < kProbeRounds; ++r) {
      const uint32_t idx = (h1 + step * h2) & cmask;
      // A stale read can only show EMPTY for a slot already taken (slots
      // are written once); the CAS below settles that case.
      unsigned long long cur = table[idx];
      if (cur == kEmpty) {
        cur = atomicCAS(&table[idx], kEmpty, key);
        if (cur == kEmpty) {
          owner[idx] = l;
          slot = (int)idx;
          break;
        }
      }
      if (cur == key) {
        slot = (int)idx;
        break;
      }
      ++step;
    }
    if (slot < 0) atomicOr(fail, 1);
  }
  slot_out[l] = slot;
}

__global__ void __launch_bounds__(kInsertThreads)
own_kernel(const int* __restrict__ slot, int n, int* owner) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const int s = slot[l];
  if (s >= 0 && owner[s] != kNoOwner) atomicMin(&owner[s], l);
}

__global__ void __launch_bounds__(kInsertThreads)
resolve_kernel(const int* __restrict__ slot, int n, int* owner,
               uint8_t* __restrict__ is_new, unsigned long long* size) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  bool nw = false;
  if (l < n) {
    const int s = slot[l];
    if (s >= 0 && owner[s] == l) {
      nw = true;
      owner[s] = kNoOwner;
    }
    is_new[l] = nw;
  }
  const int c = __syncthreads_count(nw);
  if (threadIdx.x == 0 && c) atomicAdd(size, (unsigned long long)c);
}

// The three passes on `stream`; returns the first launch error.
static inline cudaError_t launch_insert(const void* q, const void* valid,
                                        int n, void* table,
                                        long long capacity, void* owner,
                                        void* slot, void* is_new, void* size,
                                        void* fail, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kInsertThreads - 1) / kInsertThreads;
  const uint32_t cmask = (uint32_t)(capacity - 1);
  probe_claim_kernel<<<blocks, kInsertThreads, 0, stream>>>(
      (const unsigned long long*)q, (const uint8_t*)valid, n,
      (unsigned long long*)table, cmask, (int*)owner, (int*)slot,
      (int*)fail);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  own_kernel<<<blocks, kInsertThreads, 0, stream>>>((const int*)slot, n,
                                                     (int*)owner);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  resolve_kernel<<<blocks, kInsertThreads, 0, stream>>>(
      (const int*)slot, n, (int*)owner, (uint8_t*)is_new,
      (unsigned long long*)size);
  return cudaGetLastError();
}

}  // namespace rtt
