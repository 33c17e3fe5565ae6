// Lane compaction for the v3 chunk: a block scan in place of a sequential
// scan.
//
// Replaces raft_tla_tpu/ops/compact_pallas.py `_kernel` (reached through
// `_compact_jit`), which walks all B*G flat lanes one at a time in a
// `fori_loop` because a TPU grid runs in order.  The algorithm lives in
// compact.cuh (shared with the v4 front's compaction launch).
//
// Bound on the H100: bytes.  It reads the [B, G] mask (270 KB at the main
// path's B=2048, G=132) twice and writes K lane ids and K flags (160 KB):
// about 0.13 us at 3.35 TB/s.  One block cannot approach that rate; the
// design instead keeps everything in one launch with no host round trip.
// A multi-block decoupled look-back scan is the next step if this launch
// shows up in the profile.

#include "compact.cuh"

namespace {

__global__ void __launch_bounds__(rtt::kCompactThreads)
compact_kernel(const uint8_t* __restrict__ en, int B, int G, int K,
               const int32_t* __restrict__ kspread, int32_t* __restrict__ pt,
               int32_t* __restrict__ lane_id, uint8_t* __restrict__ kvalid) {
  extern __shared__ int cum[];  // [B] fan-out, then its inclusive cumsum
  __shared__ int scratch[32];
  rtt::compact_block(en, B, G, K, kspread, pt, lane_id, kvalid, cum, scratch);
}

}  // namespace

extern "C" int compact_launch(const void* en, int B, int G, int K,
                              const void* kspread, void* pt, void* lane_id,
                              void* kvalid, void* stream) {
  const size_t smem = (size_t)B * sizeof(int);
  const int e = rtt::allow_smem(compact_kernel, smem);
  if (e) return e;
  compact_kernel<<<1, rtt::kCompactThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)en, B, G, K, (const int32_t*)kspread, (int32_t*)pt,
      (int32_t*)lane_id, (uint8_t*)kvalid);
  return (int)cudaGetLastError();
}
