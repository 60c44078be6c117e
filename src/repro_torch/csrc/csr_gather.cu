// Kernels 3 and 4: CSR gather, the second pass of count -> prefix-sum -> gather
// retrieval.
//
// Replaces the Pallas kernels `csr_gather_2d` and `csr_gather_batched_2d`
// (src/repro/kernels/bucket_probe.py, `_gather_tile`).  For each output slot
// of source s:
//   row  = clip(searchsorted(offsets_s, slot, side=right) - 1, 0, num_rows-1)
//   vals = table[clip(starts_s[row] + slot - offsets_s[row], 0, table_len-1)]
//   rows = row
// with (fill, -1) in slots at or past offsets_s[num_rows] (the total).  offsets_s
// holds the num_rows + 1 exact prefix sums; the TPU kernel's INT32_MAX lane
// padding is not needed.  Rows with a zero count share an offset, and the
// side=right bisection picks the last of them, the row whose run holds the
// slot, exactly as the TPU kernel does.  With num_rows == 0 the total is
// offsets_s[0] == 0, so no slot reads starts or the table.
//
// Kernel 3 (`csr_gather`) is one CSR: gridDim.y == 1.  Kernel 4
// (`csr_gather_batched`) is the same code with blockIdx.y = source: per-source
// offsets (S, num_rows+1) and starts (S, num_rows), one shared table, output
// (S, capacity).
//
// Bound on the H100: memory.  The function reads offsets and starts once,
// the table words that the valid slots select, and writes two int32 per slot.
// Design of this first version: one thread per output slot with an exact
// binary search over the prefix sums; the offsets are read through the
// read-only cache, and the top levels of every search hit the same few lines,
// so they stay in L1/L2.  Staging the offsets with cp.async/TMA and a
// warp-cooperative search are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void csr_gather_kernel(const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ table, long long table_len,
                                  int32_t* __restrict__ vals, int32_t* __restrict__ rows,
                                  long long capacity, int num_rows, int fill) {
  const long long s = blockIdx.y;
  const int32_t* off = offsets + s * (static_cast<long long>(num_rows) + 1);
  const int32_t* st = starts + s * static_cast<long long>(num_rows);
  int32_t* v_out = vals + s * capacity;
  int32_t* r_out = rows + s * capacity;
  const long long total = __ldg(off + num_rows);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long slot = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       slot < capacity; slot += stride) {
    int32_t v = fill;
    int32_t r = -1;
    if (slot < total) {
      int lo = 0;
      int hi = num_rows + 1;
      while (lo < hi) {  // first index whose offset exceeds slot
        const int mid = (lo + hi) >> 1;
        if (static_cast<long long>(__ldg(off + mid)) <= slot) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int row = lo - 1;
      row = row < 0 ? 0 : (row > num_rows - 1 ? num_rows - 1 : row);
      long long src = static_cast<long long>(__ldg(st + row)) + (slot - __ldg(off + row));
      src = src < 0 ? 0 : (src > table_len - 1 ? table_len - 1 : src);
      v = __ldg(table + src);
      r = row;
    }
    v_out[slot] = v;
    r_out[slot] = r;
  }
}

int launch(const void* offsets, const void* starts, const void* table,
           long long table_len, void* vals, void* rows, long long capacity,
           int num_rows, int num_sources, int fill, void* stream) {
  if (capacity > 0 && num_sources > 0) {
    const int threads = 256;
    long long blocks = (capacity + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(num_sources));
    csr_gather_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(table), table_len, static_cast<int32_t*>(vals),
        static_cast<int32_t*>(rows), capacity, num_rows, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int csr_gather(const void* offsets, const void* starts, const void* table,
                          long long table_len, void* vals, void* rows,
                          long long capacity, int num_rows, int fill, void* stream) {
  return launch(offsets, starts, table, table_len, vals, rows, capacity, num_rows, 1,
                fill, stream);
}

extern "C" int csr_gather_batched(const void* offsets, const void* starts,
                                  const void* table, long long table_len, void* vals,
                                  void* rows, long long capacity, int num_rows,
                                  int num_sources, int fill, void* stream) {
  return launch(offsets, starts, table, table_len, vals, rows, capacity, num_rows,
                num_sources, fill, stream);
}
