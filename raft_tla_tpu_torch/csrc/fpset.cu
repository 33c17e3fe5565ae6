// Seen-set insert: a parallel probe with 64-bit CAS claims, its three
// passes chained by programmatic dependent launch.
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
// under a microsecond at 3.35 TB/s.  What sets the time instead is the
// slowest lane's chain of dependent random reads into a table 5x the L2
// (about 11 probes at load 0.4), and, in the first design, five device
// operations a call: a fill of `fail`, three launches (claim, own,
// resolve) and a comparison, each a launch latency apart.  This design
// keeps the three launches and issues no other operation: `fail` is
// zeroed and written by the launches, each launch is a programmatic
// dependent of the one before so their launch latencies overlap, and two
// probes of a chain are read at a time.  Folding `own` into the claim
// (reserve the owner word, then publish the key) saved a launch but
// lengthened the claim's chain of dependent accesses by more (PERF.md).

#include "fpset.cuh"

extern "C" int fpset_insert_launch(const void* q, const void* valid, int n,
                                   void* table, long long capacity,
                                   void* owner, void* slot, void* is_new,
                                   void* size, void* fail, void* stream) {
  return (int)rtt::launch_insert(q, valid, n, table, capacity, owner, slot,
                                 is_new, size, fail, nullptr, nullptr,
                                 (cudaStream_t)stream);
}

// Launch `which` of one insert of n queries (0 probe/claim, 1 own, 2
// resolve) for chip_smoke.py.
extern "C" int fpset_kernel_info(int which, int n, int* out) {
  const int blocks = rtt::insert_blocks(n);
  if (which == 0)
    return rtt::kernel_info(rtt::probe_claim_kernel, blocks,
                            rtt::kInsertThreads, 0, out);
  if (which == 1)
    return rtt::kernel_info(rtt::own_kernel, blocks, rtt::kInsertThreads, 0,
                            out);
  if (which == 2)
    return rtt::kernel_info(rtt::resolve_kernel<false>, blocks,
                            rtt::kInsertThreads, 0, out);
  return (int)cudaErrorInvalidValue;
}
