// Kernel 5: the paper's linear bucket probe (query by scanning the bucket).
//
// Replaces the Pallas kernel `bucket_probe_2d` (src/repro/kernels/bucket_probe.py:40,
// `_kernel`).  Two entries share one device routine, `count_windows`:
//
// - `bucket_probe_layer`, the table's query path: one launch per layer of a
//   versioned stack finds each routed slot's window itself, masks the count
//   and accumulates it in place.  For routed slot i of shard s:
//     pad   = rq == EMPTY (-1)
//     b     = clamp((rh - lo[s]) / stride, 0, V - 1)
//     start = offsets[s, b],  end = offsets[s, b + 1]
//     c     = #{ j < max_probe : start + j < end and keys[s, start + j] == rq }
//     c     = 0 where pad or match_e >= epoch
//     total[s, i] = c (first layer) or total[s, i] + c (the others)
//   The division truncates where the reference floors: the two differ only
//   for a negative rh - lo, which the clamp sends to bucket 0 either way.
//   Padding is sent to the trash bucket V by the reference, scanned there and
//   masked to 0; here its window is never read.  The offsets are a CSR
//   (monotone, inside [0, M]), so every window lies inside the keys.
// - `bucket_probe`, the Pallas function's own interface: starts, ends and q
//   given, each window index clipped into the table as the TPU kernel's
//   `jnp.clip` does.
// A window longer than max_probe under-counts exactly as the TPU kernel does:
// both stop after max_probe words.  The TPU kernel runs a fixed max_probe
// trips and masks; here the loop ends at the window's end, which gives the
// same count.  Keys are 32-bit patterns (uint32 carried in int32) or 2-lane
// uint64 keys (two int32 lanes, lane 0 low, read as one 8-byte word), so the
// compare is plain equality of one word: every routine is templated on the
// word type W (int32_t or long long), and a 2-lane launch reads 8-byte
// table and key words where a 1-lane one reads 4 (EMPTY is all ones either
// way).  The Pallas kernel is uint32-only; the 2-lane reference is
// `hashgraph.query_count_probe`'s jnp path (src/repro/core/hashgraph.py:505-531),
// which compares every lane.  W = int32_t is the instantiation the 1-lane
// table has always run.  The TPU kernel's (rows, 128) lane tiling is not
// carried over.
//
// Layout: every per-slot array is (S, n) int32 (the keys (S, n) words),
// offsets (S, V + 2), keys and the window entry's table (S, M) words;
// blockIdx.y is the shard, so one launch serves the S shards of a layer.
//
// Bound on the H100: memory.  Bytes once: per slot rq, rh, match_e and
// total (4 B each, total read again where it accumulates), and the offsets
// pair and the window words of each live slot, each array at most once.
// That is 1.3 ms for the base layer of the depth-6 query at D = 1 / N = 2^27
// (1.69e8 slots).  Its real floor is higher: that layer's offsets (2.01e8
// buckets, 805 MB) and keys (671 MB) are far beyond the 50 MB L2 and every
// slot lands at a random place in both, so each live slot (1.35e8; the
// rest are padding) costs at least one 32-byte sector of each: 8.6 GB,
// 2.6 ms at the streaming rate (`chip_smoke.py` counts the sectors).  A
// delta of that stack (2^23 buckets, 2^22 keys: about 55 MB) nearly fits in
// L2 when it is probed alone, which is why each layer is its own launch
// rather than one launch walking the whole stack per slot.
//
// Design.  A slot is a chain of dependent loads: the streamed slot words,
// then the offsets pair, then the window words.  So the kernel is bound by
// random loads, and by how many are in flight.  Each thread takes kSlots
// consecutive slots, read as one 16-byte load per array, and issues every
// slot's offsets pair, then the first kFirstWords words of every slot's
// window, before it compares anything; only longer windows (fewer than one
// in 10^4 at the base layer's load) go on in a loop.  The grid is one thread per
// kSlots slots, uncapped.  The streamed arrays are read and written
// evict-first (`ld.global.cs` / `st.global.cs`) so that they do not push
// the layer's tables out of L2.  Table words go through the read-only path
// and are allocated in L1 (`ld.global.nc`): the two words of a pair and the
// words of a window lie in one sector, and loads of one line in flight
// together merge into one L2 request only where the line is allocated.  (A
// variant reading them with `ld.global.nc.L1::no_allocate`, with one 8-byte
// load for an aligned pair, ran slower on every layer: each word became an
// L2 request of its own.)  Measured on the card at the base layer above,
// the kernel moves about two random sectors per live slot at the rate a
// plain `torch.gather` of one random word per slot reaches (`chip_smoke.py`
// prints both), well below the 3.35 TB/s of streamed bytes.
//
// Neither `wgmma` nor TMA serves this function: there is no product to
// compute, and TMA copies tiles of a tensor, where every access here is a
// scattered word or two at a random place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A CTA's threads are a template parameter (128 or 256, for
// __launch_bounds__), so its tile of slots, kThreads * kSlots, is
// block_rows = kThreads / 32 rows of 128 slots (4 or 8; 8 by default).
constexpr int kSlots = 4;       // routed slots a thread takes: one int4 of each slot array
constexpr int kFirstWords = 6;  // window words of every slot in flight before a compare

// One table word through the read-only path, loaded only where `pred`
// holds (else 0); the guard is a predicate, not a branch, so the loads of
// all slots are issued back to back.
__device__ __forceinline__ int32_t ld_table(const int32_t* p, bool pred) {
  int32_t v = 0;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p ld.global.nc.b32 %0, [%1];\n}"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// The same for an 8-byte word (a 2-lane key).
__device__ __forceinline__ long long ld_table(const long long* p, bool pred) {
  long long v = 0;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p ld.global.nc.b64 %0, [%1];\n}"
      : "+l"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// kSlots consecutive words of a streamed slot array: one evict-first 16-byte
// load where all are present and the address is aligned, else one word
// each; the `valid`..kSlots-1 slots past the row's end take `fill`.
__device__ __forceinline__ void load_slots(const int32_t* p, int valid, int32_t fill,
                                           int32_t (&v)[kSlots]) {
  static_assert(kSlots == 4, "one int4 per slot array");
  if (valid == kSlots && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) v[k] = k < valid ? __ldcs(p + k) : fill;
  }
}

// The same for 8-byte words: two 16-byte loads.
__device__ __forceinline__ void load_slots(const long long* p, int valid, long long fill,
                                           long long (&v)[kSlots]) {
  if (valid == kSlots && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) v[k] = k < valid ? __ldcs(p + k) : fill;
  }
}

__device__ __forceinline__ void store_slots(int32_t* p, int valid, const int32_t (&v)[kSlots]) {
  if (valid == kSlots && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k < valid) __stcs(p + k, v[k]);
    }
  }
}

template <typename W>
__device__ __forceinline__ const W* clipped(const W* table, long long len, long long idx) {
  idx = idx < 0 ? 0 : (idx > len - 1 ? len - 1 : idx);
  return table + idx;
}

// The shared routine: count[k] = #{ j < trips[k] : word j of slot k == q[k] }
// where word j is table[start[k] + j], clipped into the row's `len` words
// for the window entry (kClip; len > 0 wherever trips > 0).  The table's
// path needs no clip (its windows lie inside the keys), which keeps each
// address one add from the slot's start and the kernel at 32 registers.
// The first kFirstWords words of every slot's window are in flight before
// the first compare.
template <bool kClip, typename W>
__device__ __forceinline__ void count_windows(const W* table, long long len,
                                              const int32_t (&start)[kSlots],
                                              const int (&trips)[kSlots],
                                              const W (&q)[kSlots],
                                              int32_t (&count)[kSlots]) {
  const auto word = [&](int k, int j) {
    return kClip ? clipped(table, len, static_cast<long long>(start[k]) + j)
                 : table + start[k] + j;
  };
  W w[kFirstWords][kSlots];
#pragma unroll
  for (int j = 0; j < kFirstWords; ++j) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) w[j][k] = ld_table(word(k, j), trips[k] > j);
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    count[k] = 0;
#pragma unroll
    for (int j = 0; j < kFirstWords; ++j) {
      count[k] += static_cast<int32_t>(trips[k] > j && w[j][k] == q[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    for (int j = kFirstWords; j < trips[k]; ++j) count[k] += ld_table(word(k, j), true) == q[k];
  }
}

// The Pallas interface: windows given as starts and ends.
template <int kThreads, typename W>
__global__ void __launch_bounds__(kThreads)
    probe_windows_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                         const W* __restrict__ q, const W* __restrict__ table,
                         long long n, long long table_len, int max_probe,
                         int32_t* __restrict__ out) {
  const long long s = blockIdx.y;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kSlots;
  if (i0 >= n) return;
  const int valid = n - i0 < kSlots ? static_cast<int>(n - i0) : kSlots;
  const long long at = s * n + i0;
  int32_t st[kSlots], en[kSlots], count[kSlots];
  W key[kSlots];
  load_slots(starts + at, valid, 0, st);
  load_slots(ends + at, valid, 0, en);
  load_slots(q + at, valid, W(0), key);
  int trips[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long t = static_cast<long long>(en[k]) - st[k];
    trips[k] = table_len > 0 && t > 0 ? static_cast<int>(t < max_probe ? t : max_probe) : 0;
  }
  count_windows<true, W>(table + s * table_len, table_len, st, trips, key, count);
  store_slots(out + at, valid, count);
}

// The table's path: one layer of the stack, windows found here.
template <int kThreads, bool kMatch, typename W>
__global__ void __launch_bounds__(kThreads)
    probe_layer_kernel(const W* __restrict__ rq, const int32_t* __restrict__ rh,
                       const int32_t* __restrict__ lo, const int32_t* __restrict__ match_e,
                       const int32_t* __restrict__ offsets, const W* __restrict__ keys,
                       long long n, long long keys_len, int table_size, int stride, int epoch,
                       int max_probe, int accumulate, int32_t* __restrict__ total) {
  const long long s = blockIdx.y;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kSlots;
  if (i0 >= n) return;
  const int valid = n - i0 < kSlots ? static_cast<int>(n - i0) : kSlots;
  const long long at = s * n + i0;
  constexpr W kEmpty = -1;  // all ones in every lane
  W key[kSlots];
  int32_t h[kSlots], e[kSlots], count[kSlots];
  load_slots(rq + at, valid, kEmpty, key);
  load_slots(rh + at, valid, 0, h);
  if (kMatch) load_slots(match_e + at, valid, 0, e);
  const int32_t base = __ldg(lo + s);
  const int32_t* orow = offsets + s * (table_size + 2LL);
  int32_t start[kSlots];
  int trips[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const bool live = key[k] != kEmpty && (!kMatch || e[k] < epoch);
    const int32_t r = h[k] - base;
    int32_t b = r <= 0 ? 0 : (stride == 1 ? r : r / stride);
    b = b < table_size - 1 ? b : table_size - 1;
    const int32_t lo_w = ld_table(orow + b, live);
    const int32_t hi_w = ld_table(orow + b + 1, live);
    const int32_t t = hi_w - lo_w;  // 0 where the slot is not live
    start[k] = lo_w;
    trips[k] = keys_len > 0 && t > 0 ? (t < max_probe ? t : max_probe) : 0;
  }
  count_windows<false, W>(keys + s * keys_len, keys_len, start, trips, key, count);
  if (accumulate) {
    int32_t before[kSlots];
    load_slots(total + at, valid, 0, before);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) count[k] += before[k];
  }
  store_slots(total + at, valid, count);
}

dim3 slot_grid(long long n, int num_shards, int block) {
  const long long threads = (n + kSlots - 1) / kSlots;
  return dim3(static_cast<unsigned>((threads + block - 1) / block),
              static_cast<unsigned>(num_shards));
}

template <int kThreads, typename W>
void launch_windows(const void* starts, const void* ends, const void* q, const void* table,
                    long long n, long long table_len, int num_shards, int max_probe, void* out,
                    cudaStream_t st) {
  probe_windows_kernel<kThreads, W><<<slot_grid(n, num_shards, kThreads), kThreads, 0, st>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const W*>(q), static_cast<const W*>(table), n, table_len, max_probe,
      static_cast<int32_t*>(out));
}

template <int kThreads, typename W>
void launch_layer(const void* rq, const void* rh, const void* lo, const void* match_e,
                  const void* offsets, const void* keys, long long n, long long keys_len,
                  int num_shards, int table_size, int stride, int epoch, int max_probe,
                  int accumulate, void* total, cudaStream_t st) {
  const dim3 grid = slot_grid(n, num_shards, kThreads);
  const auto* rq_p = static_cast<const W*>(rq);
  const auto* rh_p = static_cast<const int32_t*>(rh);
  const auto* lo_p = static_cast<const int32_t*>(lo);
  const auto* e_p = static_cast<const int32_t*>(match_e);
  const auto* off_p = static_cast<const int32_t*>(offsets);
  const auto* keys_p = static_cast<const W*>(keys);
  auto* out = static_cast<int32_t*>(total);
  if (match_e != nullptr) {
    probe_layer_kernel<kThreads, true, W><<<grid, kThreads, 0, st>>>(
        rq_p, rh_p, lo_p, e_p, off_p, keys_p, n, keys_len, table_size, stride, epoch,
        max_probe, accumulate, out);
  } else {
    probe_layer_kernel<kThreads, false, W><<<grid, kThreads, 0, st>>>(
        rq_p, rh_p, lo_p, e_p, off_p, keys_p, n, keys_len, table_size, stride, epoch,
        max_probe, accumulate, out);
  }
}

template <int kThreads>
void windows_lanes(const void* starts, const void* ends, const void* q, const void* table,
                   long long n, long long table_len, int num_shards, int max_probe, int lanes,
                   void* out, cudaStream_t st) {
  if (lanes == 1) {
    launch_windows<kThreads, int32_t>(starts, ends, q, table, n, table_len, num_shards,
                                      max_probe, out, st);
  } else {
    launch_windows<kThreads, long long>(starts, ends, q, table, n, table_len, num_shards,
                                        max_probe, out, st);
  }
}

template <int kThreads>
void layer_lanes(const void* rq, const void* rh, const void* lo, const void* match_e,
                 const void* offsets, const void* keys, long long n, long long keys_len,
                 int num_shards, int table_size, int stride, int epoch, int max_probe,
                 int accumulate, int lanes, void* total, cudaStream_t st) {
  if (lanes == 1) {
    launch_layer<kThreads, int32_t>(rq, rh, lo, match_e, offsets, keys, n, keys_len,
                                    num_shards, table_size, stride, epoch, max_probe,
                                    accumulate, total, st);
  } else {
    launch_layer<kThreads, long long>(rq, rh, lo, match_e, offsets, keys, n, keys_len,
                                      num_shards, table_size, stride, epoch, max_probe,
                                      accumulate, total, st);
  }
}

}  // namespace

// Both entries take `threads`, a CTA's threads: 128 or 256 (the default).
// lanes: 1 (4-byte keys) or 2 (8-byte keys: two int32 lanes, 8-byte aligned);
// q and table hold words of that size, table_len counts words.
extern "C" int bucket_probe(const void* starts, const void* ends, const void* q,
                            const void* table, long long n, long long table_len,
                            int num_shards, int max_probe, int lanes, int threads, void* out,
                            void* stream) {
  if ((lanes != 1 && lanes != 2) || (threads != 128 && threads != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && num_shards > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (threads == 128) {
      windows_lanes<128>(starts, ends, q, table, n, table_len, num_shards, max_probe, lanes,
                         out, st);
    } else {
      windows_lanes<256>(starts, ends, q, table, n, table_len, num_shards, max_probe, lanes,
                         out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// rq and keys hold words of `lanes` int32 lanes (1 or 2); keys_len counts words.
extern "C" int bucket_probe_layer(const void* rq, const void* rh, const void* lo,
                                  const void* match_e, const void* offsets, const void* keys,
                                  long long n, long long keys_len, int num_shards,
                                  int table_size, int stride, int epoch, int max_probe,
                                  int accumulate, int lanes, int threads, void* total,
                                  void* stream) {
  if ((lanes != 1 && lanes != 2) || (threads != 128 && threads != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && num_shards > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (threads == 128) {
      layer_lanes<128>(rq, rh, lo, match_e, offsets, keys, n, keys_len, num_shards, table_size,
                       stride, epoch, max_probe, accumulate, lanes, total, st);
    } else {
      layer_lanes<256>(rq, rh, lo, match_e, offsets, keys, n, keys_len, num_shards, table_size,
                       stride, epoch, max_probe, accumulate, lanes, total, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
