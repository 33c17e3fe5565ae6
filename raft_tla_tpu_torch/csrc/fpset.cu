// Seen-set insert: a parallel probe with 64-bit CAS claims.
//
// Replaces raft_tla_tpu/ops/fpset_pallas.py `_kernel` (reached through
// `_insert_padded`), which inserts its queries one at a time through
// single-element DMAs because a TPU grid runs in order.  The passes and
// the lowest-lane ownership rule are in fpset.cuh.
//
// Bound on the H100: bytes, and latency.  At the main path's shapes
// (32,768 queries into a 2^25-slot, 256 MB table) the work is the queries,
// one 32-byte sector read per distinct key (a duplicate finds its key
// where the first lane did) and one written per claimed slot, about 1 MB:
// under a microsecond at 3.35 TB/s.  The probes are dependent random
// reads, so each lane waits one DRAM latency per probe; the design keeps
// one lane per query and enough lanes in flight (128 blocks of 256) to
// hide that latency across lanes, and the owner passes touch only the
// slots claimed in this call.

#include "fpset.cuh"

extern "C" int fpset_insert_launch(const void* q, const void* valid, int n,
                                   void* table, long long capacity,
                                   void* owner, void* slot, void* is_new,
                                   void* size, void* fail, void* stream) {
  return (int)rtt::launch_insert(q, valid, n, table, capacity, owner, slot,
                                 is_new, size, fail, (cudaStream_t)stream);
}
