// Kernel 6: blockwise online-softmax (flash) attention, forward.
//
// Replaces the Pallas kernel `flash_attention_fhsd`
// (src/repro/kernels/flash_attention.py, `_kernel`).  Over the flattened-head
// layout q (Hq, Sq, D), k/v (Hkv, Skv, D), query head h reading kv head
// h / group, it computes for every query row
//   s = (q * scale) . k^T in f32, masked by
//       k_pos < Skv, and
//       causal:            k_pos <= q_pos + (Skv - Sq)  [and, with a window,
//                          k_pos >  q_pos + (Skv - Sq) - window]
//       not causal+window: |k_pos - q_pos| < window
//   o = softmax(s) . v with an f32 running max, sum and accumulator,
// a row with no live key giving 0, and writes o in q's type (bf16 or f32).
//
// Design (right first, fast later):
// * one block of 128 threads (4 warps) per (tile of 64 query rows, query
//   head); the kv loop runs inside the block over tiles of 64 keys, in place
//   of the TPU kernel's sequential kv grid axis, so the running max, sum and
//   accumulator live in registers for the whole row tile;
// * only the kv tiles the causal or window mask can reach are visited (the
//   TPU kernel's `pl.when(live)`): causal attention does half the work;
// * the group's kv head is read straight from its (Hkv, Skv, D) array: kv is
//   never copied per query head;
// * tiles are staged through shared memory with rows past Sq or Skv as
//   zeros, so padded value rows cannot poison the accumulator (the TPU
//   kernel's `col_valid`).
// bf16 (`flash_fwd_mma`, the serving path): both products on the tensor
// cores with `mma.sync.m16n8k16` (bf16 in, f32 accumulate).  Each warp owns
// 16 query rows; its q fragments stay in registers for the whole kv loop,
// the scores come back in the accumulator layout, are scaled, masked and
// exponentiated in f32, and are fed straight back as the A operand of the
// p.v product (p rounded to bf16 there, as v is; the sums stay f32).  Row
// max and sum are reduced over the 4 lanes that share a row.  Shared-memory
// rows are padded by 8 elements so every fragment load is conflict-free.
// f32 (`flash_fwd_fma`, tests and small shapes): the same tiling on the
// f32 FMA units, so the scores and p.v keep full f32 precision; thread
// (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4), score
// columns tx + 8 j (j < 8) and output columns 4 tx + 32 j + e.
//
// Bound on the H100: operations.  With the causal mask the kept FLOPs are
// ~4 * Hq * D * (live scores); at Sq = Skv = 2675, D = 128, Hq = 32 that is
// 5.9e10 FLOP, 59 us at the 989 TFLOP/s bf16 tensor-core rate, against 3.4 MB
// of q, k, v and o (16 us at 3.35 TB/s).  `mma.sync` reaches a fraction of
// that rate (wgmma is the only way to all of it), the k/v tiles are loaded
// synchronously and re-read per query tile from L2; wgmma, TMA and a
// pipelined k/v ring are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 128;  // 4 warps
constexpr int PS = 68;        // row stride of the f32 kernel's probability tile (floats)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D + 4;                 // q/k row stride: conflict-free float4 rows
  static constexpr int KS = QS > PS ? QS : PS;     // the k tile also holds the 64 x PS probabilities
  static constexpr int FLOATS = BQ * QS + BKV * KS + BKV * D;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq, int skv, int group,
              int causal, int window, float scale) {
  using S = Smem<D>;
  constexpr int QS = S::QS, KS = S::KS;
  constexpr int DJ = D / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x QS
  float* Ks = Qs + BQ * QS;                     // BKV x KS: k, then p
  float* Vs = Ks + BKV * KS;                    // BKV x D

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long hk = h / group;
  const float* qh = q + static_cast<long long>(h) * sq * D;
  const float* kh = k + hk * skv * D;
  const float* vh = v + hk * skv * D;
  float* oh = o + static_cast<long long>(h) * sq * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] = q0 + r < sq ? qh[static_cast<long long>(q0 + r) * D + c] * scale : 0.f;
  }

  // The kv range the mask can reach from this query tile.
  const bool has_window = window >= 0;
  const int offset = causal ? skv - sq : 0;
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_hi = skv - 1, k_lo = 0;
  if (causal) {
    k_hi = min(k_hi, q_last + offset);
  } else if (has_window) {
    k_hi = min(k_hi, q_last + window - 1);
  }
  if (has_window) k_lo = max(0, q0 + offset - window + 1);

  float m[4], l[4], acc[4][4 * DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DJ; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (k_lo / BKV) * BKV; k_lo <= k_hi && t0 <= k_hi; t0 += BKV) {
    __syncthreads();  // the previous tile's p and v are consumed (and q is staged)
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < skv;
      const long long g = static_cast<long long>(t0 + r) * D + c;
      Ks[r * KS + c] = in ? kh[g] : 0.f;
      Vs[r * D + c] = in ? vh[g] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * KS + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

    // Mask, then the online-softmax update of each of this thread's rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = t0 + tx + 8 * j;
        bool ok = kp < skv;
        if (causal) {
          ok = ok && kp <= qp + offset;
          if (has_window) ok = ok && kp > qp + offset - window;
        } else if (has_window) {
          ok = ok && abs(kp - qp) < window;
        }
        live |= static_cast<unsigned>(ok) << j;
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = (live >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DJ; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every score is read from k: the tile now takes p
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty + 16 * i) * PS + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(kk + e) * D + 4 * tx + 32 * jj]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* row = oh + static_cast<long long>(r) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[4 * tx + 32 * jj + e] = acc[i][4 * jj + e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct SmemMma {
  static constexpr int LD = D + 8;  // row stride (elements): conflict-free fragment loads
  static constexpr size_t BYTES = (BQ + 2 * BKV) * LD * sizeof(__nv_bfloat16);
};

// rows [row0, row0 + 64) of a (nrows, D) bf16 array into a 64 x LD tile,
// 16 bytes per load; rows past nrows are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int nrows, int tid) {
  constexpr int CHUNKS = D / 8;
  for (int i = tid; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * SmemMma<D>::LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int sq,
              int skv, int group, int causal, int window, float scale) {
  constexpr int LD = SmemMma<D>::LD;
  constexpr int KSTEPS = D / 16;  // k-steps of q.k
  constexpr int NT = D / 8;       // n-tiles of the output
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const long long hk = h / group;
  const __nv_bfloat16* qh = q + static_cast<long long>(h) * sq * D;
  const __nv_bfloat16* kh = k + hk * skv * D;
  const __nv_bfloat16* vh = v + hk * skv * D;
  __nv_bfloat16* oh = o + static_cast<long long>(h) * sq * D;

  load_tile<D>(Qs, qh, q0, sq, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const __nv_bfloat16* a = Qs + r0 * LD + ks * 16 + 2 * t;
    qf[ks][0] = ld32(a);
    qf[ks][1] = ld32(a + 8 * LD);
    qf[ks][2] = ld32(a + 8);
    qf[ks][3] = ld32(a + 8 * LD + 8);
  }

  const bool has_window = window >= 0;
  const int offset = causal ? skv - sq : 0;
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_hi = skv - 1, k_lo = 0;
  if (causal) {
    k_hi = min(k_hi, q_last + offset);
  } else if (has_window) {
    k_hi = min(k_hi, q_last + window - 1);
  }
  if (has_window) k_lo = max(0, q0 + offset - window + 1);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t0 = (k_lo / BKV) * BKV; k_lo <= k_hi && t0 <= k_hi; t0 += BKV) {
    __syncthreads();  // every warp is done with the previous k and v tiles
    load_tile<D>(Ks, kh, t0, skv, tid);
    load_tile<D>(Vs, vh, t0, skv, tid);
    __syncthreads();

    // s (16 x 64 per warp) = q . k^T, as 8 accumulator tiles of 16 x 8.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const __nv_bfloat16* b = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma16816(s[nt], qf[ks], ld32(b), ld32(b + 8));
      }
    }

    // Scale, mask and the online-softmax update of rows r0 (half 0) and r0 + 8.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = q0 + r0 + 8 * half;
      float mx = NEG_INF;
      unsigned live = 0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = t0 + nt * 8 + 2 * t + e;
          bool ok = kp < skv;
          if (causal) {
            ok = ok && kp <= qp + offset;
            if (has_window) ok = ok && kp > qp + offset - window;
          } else if (has_window) {
            ok = ok && abs(kp - qp) < window;
          }
          live |= static_cast<unsigned>(ok) << (2 * nt + e);
          const float val = ok ? s[nt][2 * half + e] * scale : NEG_INF;
          s[nt][2 * half + e] = val;
          mx = fmaxf(mx, val);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float alpha = expf(m[half] - m_new);
      m[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = (live >> (2 * nt + e)) & 1u ? expf(s[nt][2 * half + e] - m_new) : 0.f;
          s[nt][2 * half + e] = p;
          sum += p;
        }
      }
      l[half] = l[half] * alpha + sum;  // this lane's share; the quad sums at the end
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }

    // acc (16 x D per warp) += p (16 x 64) . v (64 x D): p from the score
    // accumulators, 16 keys per k-step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* b = vb + n * 8;
        mma16816(acc[n], a, pack_bf16(b[0], b[LD]), pack_bf16(b[8 * LD], b[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = q0 + r0 + 8 * half;
    if (r >= sq) continue;
    const float denom = sum == 0.f ? 1.f : sum;
    __nv_bfloat16* row = oh + static_cast<long long>(r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_f32(acc[n][2 * half] / denom, acc[n][2 * half + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int hq, int sq,
                       int skv, int group, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_fma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, hq);
  flash_fwd_fma<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, skv, group, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int hq, int sq,
                       int skv, int group, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = SmemMma<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, hq);
  flash_fwd_mma<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, skv, group,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, int hq, int sq,
                         int skv, int group, int causal, int window, float scale, int is_bf16,
                         cudaStream_t stream) {
  return is_bf16 ? launch_mma<D>(q, k, v, o, hq, sq, skv, group, causal, window, scale, stream)
                 : launch_fma<D>(q, k, v, o, hq, sq, skv, group, causal, window, scale, stream);
}

}  // namespace

// q (hq, sq, d), k/v (hq / group, skv, d), o (hq, sq, d), all contiguous and of
// one type (is_bf16 ? bf16 : f32); window < 0 means none.  Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a head dim other than 32, 64, 128).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int hq,
                               int sq, int skv, int d, int group, int causal, int window,
                               float scale, int is_bf16, void* stream) {
  if (hq <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 32: err = launch_typed<32>(q, k, v, o, hq, sq, skv, group, causal, window, scale, is_bf16, st); break;
    case 64: err = launch_typed<64>(q, k, v, o, hq, sq, skv, group, causal, window, scale, is_bf16, st); break;
    case 128: err = launch_typed<128>(q, k, v, o, hq, sq, skv, group, causal, window, scale, is_bf16, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
