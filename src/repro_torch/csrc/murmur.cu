// Kernel 1: fused MurmurHash3_x86_32 + bucket id.
//
// Replaces the Pallas kernel `murmur_bucket_2d` (src/repro/kernels/murmur.py,
// tile `_murmur_tile`): bucket[i] = murmur3_x86_32(keys[i], seed) % table_size
// as int32, one uint32 word per key.  The same kernel serves DEFAULT_SEED and
// FINGERPRINT_SEED; both are arguments.
//
// Bound on the H100: memory.  Each key is read once (4 bytes) and its bucket
// written once (4 bytes); the ~20 integer operations per key are far below the
// card's integer rate.  Design: an elementwise grid-stride loop, 16-byte
// (uint4 / int4) loads and stores on the aligned body so each thread moves four
// keys per memory instruction, a scalar loop for the tail.  The intermediate
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

}  // namespace

// keys and out must be 16-byte aligned (fresh PyTorch allocations are).
extern "C" int murmur_bucket(const void* keys, void* out, long long n,
                             unsigned seed, unsigned table_size, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n / 4 + threads - 1) / threads;
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 16) blocks = 132 * 16;
    murmur_bucket_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), n, seed,
        table_size);
  }
  return static_cast<int>(cudaGetLastError());
}
