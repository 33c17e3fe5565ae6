// Shared device helpers for the port's Hopper kernels (sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rtt {

// murmur3 finalizer: the same 32-bit avalanche as the fingerprint and the
// seen-set probe base of the JAX package (ops/fingerprint.py fmix32).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Exclusive scan of one int per thread across the block.  blockDim.x must
// be a multiple of 32 (at most 1024); `smem` holds 32 ints.  Every thread
// gets its exclusive prefix and the block total; the trailing barrier makes
// `smem` reusable by the next call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    smem[lane] = w;
  }
  __syncthreads();
  const int res = (warp ? smem[warp - 1] : 0) + x - v;
  *total = smem[nwarps - 1];
  __syncthreads();
  return res;
}

// Host side: let `kernel` take `bytes` of dynamic shared memory, opting in
// above the 48 KB every kernel gets.  Returns a cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace rtt
