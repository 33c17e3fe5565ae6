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

// Programmatic dependent launch (Hopper): a kernel launched with
// `dependent` set may start while the kernel before it on the stream is
// still running, and must call grid_dependency_wait() before it reads what
// that kernel writes.  Such data must not reach the kernel through a
// `const __restrict__` pointer: the compiler takes it for read-only over
// the whole kernel and may load it before the wait.  launch_dependents()
// in the earlier kernel lets the later one's blocks become resident early.
// Without the attribute the wait returns at once.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Host side: launch `kernel` with `smem` bytes of dynamic shared memory
// on `stream`, as a programmatic dependent of the launch before it when
// `dependent` is set.  Returns a cudaError_t.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_smem(void (*kernel)(KArgs...), int grid, int block,
                               size_t smem, cudaStream_t stream,
                               bool dependent, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, (KArgs)args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// launch_smem without dynamic shared memory.
template <typename... KArgs, typename... Args>
inline cudaError_t launch(void (*kernel)(KArgs...), int grid, int block,
                          cudaStream_t stream, bool dependent,
                          Args... args) {
  return launch_smem(kernel, grid, block, 0, stream, dependent, args...);
}

// Host side: let `kernel` take `bytes` of dynamic shared memory, opting in
// above the 48 KB every kernel gets.  Returns a cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Host side: one launch's shape and what its kernel was built with, into
// out[7] = grid, block, dynamic shared bytes, registers a thread, local
// (spill) bytes a thread, static shared bytes, max threads a block.
// Returns a cudaError_t.
template <typename Kernel>
inline int kernel_info(Kernel kernel, int grid, int block, size_t smem,
                       int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = grid;
  out[1] = block;
  out[2] = (int)smem;
  out[3] = a.numRegs;
  out[4] = (int)a.localSizeBytes;
  out[5] = (int)a.sharedSizeBytes;
  out[6] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace rtt
