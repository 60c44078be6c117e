// Kernel 5: the paper's linear bucket probe (query by scanning the bucket).
//
// Replaces the Pallas kernel `bucket_probe_2d` (src/repro/kernels/bucket_probe.py,
// `_kernel`).  For each routed query slot i of shard s:
//   out[s,i] = sum_{j < max_probe} [starts[s,i] + j < ends[s,i]
//                                   and table[s, clip(starts[s,i] + j)] == q[s,i]]
// where clip() keeps the index inside the shard's table, as the TPU kernel's
// `jnp.clip` does.  A window longer than max_probe under-counts exactly as the
// TPU kernel does: both stop after max_probe words.  The TPU kernel runs a
// fixed max_probe trips and masks; here the loop ends at the window's end,
// which gives the same count (trips past the end match nothing).
//
// Keys are 32-bit patterns (the port carries uint32 keys in int32), so the
// compare is plain 32-bit equality and the sign does not matter.  The TPU
// kernel's (rows, 128) lane tiling is not carried over.
//
// Layout: starts, ends, q and out are (S, n) int32, the table (S, table_len);
// blockIdx.y is the shard, so one launch serves the D shards of a layer.
//
// Bound on the H100: memory.  The function reads starts, ends and q once,
// writes one count, and reads the table words inside each window (at most
// max_probe).  Design of this first version: one thread per query slot, the
// slot arrays read coalesced, the window read through the read-only cache.
// Windows hold a few words on average, so a warp's loads scatter over the
// table; gathering neighbouring windows into shared memory is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bucket_probe_kernel(const int32_t* __restrict__ starts,
                                    const int32_t* __restrict__ ends,
                                    const int32_t* __restrict__ q,
                                    const int32_t* __restrict__ table, long long n,
                                    long long table_len, int max_probe,
                                    int32_t* __restrict__ out) {
  const long long s = blockIdx.y;
  const int32_t* st = starts + s * n;
  const int32_t* en = ends + s * n;
  const int32_t* qs = q + s * n;
  const int32_t* tb = table + s * table_len;
  int32_t* o = out + s * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long lo = st[i];
    long long trips = static_cast<long long>(en[i]) - lo;
    trips = trips < max_probe ? trips : max_probe;
    const int32_t key = qs[i];
    int32_t count = 0;
    for (long long j = 0; j < trips; ++j) {
      long long idx = lo + j;
      idx = idx < 0 ? 0 : (idx > table_len - 1 ? table_len - 1 : idx);
      count += __ldg(tb + idx) == key;
    }
    o[i] = count;
  }
}

}  // namespace

extern "C" int bucket_probe(const void* starts, const void* ends, const void* q,
                            const void* table, long long n, long long table_len,
                            int num_shards, int max_probe, void* out, void* stream) {
  if (n > 0 && num_shards > 0 && table_len > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(num_shards));
    bucket_probe_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        static_cast<const int32_t*>(q), static_cast<const int32_t*>(table), n, table_len,
        max_probe, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
