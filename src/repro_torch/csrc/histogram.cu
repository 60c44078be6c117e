// Kernel 2: coarse-bin histogram of Phase 1 (Alg. 2 lines 6-8).
//
// Replaces the Pallas kernel `histogram_2d` (src/repro/kernels/histogram.py):
// hist[b] = #{i : bins[i] == b} for b in [0, num_bins); ids outside that range
// (the port marks masked rows with -1) are ignored.
//
// The TPU has no atomics, so its kernel compares a tile of ids with a tile of
// candidate bins.  Here it is the paper's own form: each block counts into a
// shared-memory histogram of num_bins int32 with atomicAdd, then merges its
// non-zero counters into the global histogram with atomicAdd.  Integer sums
// commute, so the result is exact whatever order the atomics land in.
//
// Bound on the H100: memory.  Each id is read once (4 bytes per key) and the
// num_bins counters written once.  Design: int4 loads on the aligned body; the
// shared histogram (num_bins = O(sqrt(hash_range)): 46.6 KB at 2^27, at most
// ~186 KB at 2^31) takes dynamic shared memory, above 48 KB after
// cudaFuncSetAttribute; the grid is sized to one wave of resident blocks so the
// global merge costs (resident blocks x num_bins) atomics at most.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may opt into

__device__ __forceinline__ void count(int32_t b, int32_t* hist, int num_bins) {
  if (b >= 0 && b < num_bins) atomicAdd(&hist[b], 1);
}

__global__ void bin_histogram_kernel(const int32_t* __restrict__ bins, long long n,
                                     int32_t* __restrict__ hist, int num_bins) {
  extern __shared__ int32_t local[];
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) local[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  const int4* bins4 = reinterpret_cast<const int4*>(bins);
  for (long long i = tid; i < n4; i += stride) {
    int4 b = bins4[i];
    count(b.x, local, num_bins);
    count(b.y, local, num_bins);
    count(b.z, local, num_bins);
    count(b.w, local, num_bins);
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) count(bins[i], local, num_bins);
  __syncthreads();
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) {
    const int32_t c = local[i];
    if (c != 0) atomicAdd(&hist[i], c);
  }
}

}  // namespace

// bins must be 16-byte aligned; hist is zeroed here before the launch.
// threads: a block's threads, a multiple of 32 up to 1024 (512 by default:
// the resolver's block_rows x 32, a CTA's vector loads covering block_rows
// rows of 128 ids).
extern "C" int bin_histogram(const void* bins, long long n, void* hist, int num_bins,
                             int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(num_bins) * sizeof(int32_t);
  if (num_bins <= 0 || smem > static_cast<size_t>(kMaxSharedBytes) || threads < 32 ||
      threads > 1024 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(hist, 0, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bin_histogram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_histogram_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long needed = (n / 4 + threads - 1) / threads;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;
  bin_histogram_kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      static_cast<const int32_t*>(bins), n, static_cast<int32_t*>(hist), num_bins);
  return static_cast<int>(cudaGetLastError());
}
