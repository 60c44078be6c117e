// Kernel 1: fused MurmurHash3_x86_32 + bucket id.
//
// Replaces the Pallas kernel `murmur_bucket_2d` (src/repro/kernels/murmur.py,
// tile `_murmur_tile`): bucket[i] = murmur3_x86_32(keys[i], seed) % table_size
// as int32, one uint32 word per key.  The same kernel serves DEFAULT_SEED and
// FINGERPRINT_SEED; both are arguments.
//
// Two entries:
// - `murmur_bucket`, one word a key, the bucket id alone: the 1-lane path,
//   `murmur_bucket_kernel` below.
// - `murmur_hash`, L = 1 or 2 words a key (the 2-lane uint64 packing, lane 0
//   the low word: MurmurHash3_x86_32 of the 8-byte little-endian key, whose
//   tail mix is h ^= 4 L), with two outputs chosen per launch: the bucket id
//   under `seed` and the raw 32-bit hash under `fp_seed` (the probe
//   fingerprint, `hashing.fingerprint32`).  With both, each key is read once
//   for the two hashes (the owner side of a routed batch needs both).  The
//   reference computes the multi-word hash in plain jnp
//   (src/repro/core/hashing.py:81-127): its Pallas kernel takes one word.
//
// Bound on the H100: memory.  Each key is read once (4 bytes) and its bucket
// written once (4 bytes); the ~20 integer operations per key are far below the
// card's integer rate.  Design: an elementwise grid-stride loop, 16-byte
// (uint4 / int4) loads and stores on the aligned body so each thread moves four
// keys per memory instruction, a scalar loop for the tail.  A block's threads
// are a launch argument (the resolver's block_rows x 32: a CTA's tile is
// block_rows rows of 128 words, as a Pallas grid step's was); the default is
// 256.  The intermediate
// 32-bit hash never leaves registers (the fusion the TPU kernel makes in VMEM).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int32_t bucket_of(uint32_t k, uint32_t seed,
                                             uint32_t table_size) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = seed ^ k;
  h = rotl32(h, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;  // total length in bytes
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return static_cast<int32_t>(h % table_size);
}

__global__ void murmur_bucket_kernel(const uint32_t* __restrict__ keys,
                                     int32_t* __restrict__ out, long long n,
                                     uint32_t seed, uint32_t table_size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    uint4 k = keys4[i];
    int4 b;
    b.x = bucket_of(k.x, seed, table_size);
    b.y = bucket_of(k.y, seed, table_size);
    b.z = bucket_of(k.z, seed, table_size);
    b.w = bucket_of(k.w, seed, table_size);
    out4[i] = b;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) {
    out[i] = bucket_of(keys[i], seed, table_size);
  }
}

template <int L>
__device__ __forceinline__ uint32_t murmur_words(const uint32_t* w, uint32_t seed) {
  uint32_t h = seed;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint32_t k = w[i] * 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= 4u * L;  // total length in bytes
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// kRows int32 outputs with one 16-byte (kRows == 4) or 8-byte store.
template <int kRows>
__device__ __forceinline__ void store_rows(int32_t* p, const int32_t (&v)[kRows]) {
  if constexpr (kRows == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  }
}

// L words a key; 16-byte loads take 4 / L keys, the outputs of those keys go
// out in one store each.  Bound by memory like the 1-word kernel: 4 L bytes
// read and 4 bytes written per output per key.
template <int L, bool kBucket, bool kFp>
__global__ void murmur_hash_kernel(const uint32_t* __restrict__ keys,
                                   int32_t* __restrict__ bucket, int32_t* __restrict__ fp,
                                   long long n, uint32_t seed, uint32_t fp_seed,
                                   uint32_t table_size) {
  constexpr int kRows = 4 / L;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nv = n / kRows;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  for (long long i = tid; i < nv; i += stride) {
    const uint4 k = keys4[i];
    const uint32_t w[4] = {k.x, k.y, k.z, k.w};
    int32_t b[kRows], f[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kBucket) b[r] = static_cast<int32_t>(murmur_words<L>(w + r * L, seed) % table_size);
      if (kFp) f[r] = static_cast<int32_t>(murmur_words<L>(w + r * L, fp_seed));
    }
    if (kBucket) store_rows<kRows>(bucket + i * kRows, b);
    if (kFp) store_rows<kRows>(fp + i * kRows, f);
  }
  for (long long i = nv * kRows + tid; i < n; i += stride) {
    if (kBucket) bucket[i] = static_cast<int32_t>(murmur_words<L>(keys + i * L, seed) % table_size);
    if (kFp) fp[i] = static_cast<int32_t>(murmur_words<L>(keys + i * L, fp_seed));
  }
}

// Blocks of `threads` threads (a CTA's tile: `threads` 16-byte vectors, i.e.
// block_rows = threads / 32 rows of 128 words), enough for one vector a
// thread, the grid capped at 132 x 16 blocks of 256 threads' worth of
// threads (the grid-stride loop takes the rest).
long long grid_for(long long vectors, int threads) {
  constexpr long long kMaxThreads = 132LL * 16 * 256;
  long long blocks = (vectors + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxThreads / threads) blocks = kMaxThreads / threads;
  return blocks;
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

template <int L, bool kBucket, bool kFp>
void launch_hash(const void* keys, void* bucket, void* fp, long long n, unsigned seed,
                 unsigned fp_seed, unsigned table_size, int threads, cudaStream_t stream) {
  const long long blocks = grid_for(n / (4 / L), threads);
  murmur_hash_kernel<L, kBucket, kFp><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(bucket),
      static_cast<int32_t*>(fp), n, seed, fp_seed, table_size);
}

template <int L>
void launch_lanes(const void* keys, void* bucket, void* fp, long long n, unsigned seed,
                  unsigned fp_seed, unsigned table_size, int threads, cudaStream_t stream) {
  if (bucket != nullptr && fp != nullptr) {
    launch_hash<L, true, true>(keys, bucket, fp, n, seed, fp_seed, table_size, threads, stream);
  } else if (bucket != nullptr) {
    launch_hash<L, true, false>(keys, bucket, fp, n, seed, fp_seed, table_size, threads, stream);
  } else {
    launch_hash<L, false, true>(keys, bucket, fp, n, seed, fp_seed, table_size, threads, stream);
  }
}

}  // namespace

// keys and out must be 16-byte aligned (fresh PyTorch allocations are);
// threads: a block's threads, a multiple of 32 up to 1024 (256 by default).
extern "C" int murmur_bucket(const void* keys, void* out, long long n,
                             unsigned seed, unsigned table_size, int threads, void* stream) {
  if (!valid_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long blocks = grid_for(n / 4, threads);
    murmur_bucket_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), n, seed,
        table_size);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys (n, lanes) uint32 words, 16-byte aligned; bucket and fp (n,) int32,
// either null (not written), 16-byte aligned.  lanes is 1 or 2.
extern "C" int murmur_hash(const void* keys, void* bucket, void* fp, long long n, int lanes,
                           unsigned seed, unsigned fp_seed, unsigned table_size, int threads,
                           void* stream) {
  if ((lanes != 1 && lanes != 2) || (bucket == nullptr && fp == nullptr) ||
      !valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lanes == 1) {
      launch_lanes<1>(keys, bucket, fp, n, seed, fp_seed, table_size, threads, st);
    } else {
      launch_lanes<2>(keys, bucket, fp, n, seed, fp_seed, table_size, threads, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
