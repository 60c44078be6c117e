// Kernel 6: blockwise online-softmax (flash) attention, forward.
//
// Replaces the Pallas kernel `flash_attention_fhsd`
// (src/repro/kernels/flash_attention.py, `_kernel`).  Over q (B, Hq, Sq, D)
// and k/v (B, Hkv, Skv, D), query head h reading kv head h / group, it
// computes for every query row
//   s = (q * scale) . k^T in f32, masked by
//       k_pos < Skv, and
//       causal:            k_pos <= q_pos + (Skv - Sq)  [and, with a window,
//                          k_pos >  q_pos + (Skv - Sq) - window]
//       not causal+window: |k_pos - q_pos| < window
//   o = softmax(s) . v with an f32 running max, sum and accumulator,
// a row with no live key giving 0, and writes o in q's type (bf16 or f32).
//
// Every operand is a strided view: the last dim contiguous, the batch, head
// and row strides multiples of 16 bytes, the base 16-byte aligned (what a
// TMA tensor map takes).  So the model hands over the permuted views of its
// projections and an output buffer in its own (B, S, Hq, D) layout, and no
// copy is made on either side.  Common to both kernels: the kv loop runs
// inside the block (in place of the TPU kernel's sequential kv grid axis),
// so the running max, sum and accumulator live in registers; only the kv
// tiles the causal or window mask can reach are visited (the TPU kernel's
// `pl.when(live)`), from `k_lo` to `k_hi`; rows past Sq or Skv are staged as
// zeros, so a padded value row never reaches the accumulator (the TPU
// kernel's `col_valid`).
//
// bf16 (`flash_fwd_wgmma`, the serving path), the shape of a Hopper kernel:
// * work items of 128 query rows of one (batch, head); a persistent grid of
//   one block per SM walks them in a snake over the heaviest-first order
//   (under causal the last query tiles see the most keys), with the query
//   heads of one kv head adjacent so their k/v tiles come from L2;
// * a block runs 3 warpgroups: warpgroup 0 is the producer (one thread
//   issues TMA loads; `setmaxnreg` drops it to 24 registers), warpgroups 1
//   and 2 consume 64 query rows of the item each (240 registers);
// * TMA loads q once per item and the k and v tiles (128 keys) into a ring
//   of 3 stages, with an mbarrier full/empty pair per stage and one for q;
//   the ring runs on across items, so the next item's loads overlap this
//   one's last p.v and its stores.  TMA zero-fills rows past Sq and Skv.
//   Smem rows are swizzled by the tensor map (128-byte swizzle; D = 32 rows
//   are 64 bytes, so 64-byte swizzle there), and a D = 128 row is two
//   64-column boxes.  D = 128: q 32 KB + 3 x (k 32 KB + v 32 KB) = 224 KB.
//   D = 256 (four boxes a row) takes 64-key tiles in 2 stages: q 64 KB +
//   2 x (k 32 KB + v 32 KB) = 192 KB;
// * s = q.k^T is `wgmma` m64n128k16 (m64n64k16 at D = 256) with both
//   operands in shared memory (K-major, as stored); o += p.v is `wgmma`
//   m64nDk16 (two m64n128k16 halves at D = 256, whose o accumulator is
//   128 f32 registers a consumer thread) with p as the
//   register A operand, packed to bf16 from the s accumulator (whose
//   per-warp layout is the m16n8 accumulator layout), and v read from
//   shared memory as an MN-major B operand through the descriptor's
//   transpose bit.  p is rounded to bf16 there, as v is; max, sum and
//   accumulator stay f32;
// * overlap: each consumer issues tile j's q.k^T together with tile j-1's
//   p.v and runs tile j's softmax while that p.v is on the tensor cores;
//   the two consumers take turns to issue (FA3's ping-pong, two named
//   barriers), so one's softmax also runs under the other's products.  The
//   first tile of an item is peeled off the loop: with the two paths merged
//   in one loop, ptxas serialised every wgmma (C7514);
// * softmax in the log2 domain: s * (scale * log2 e) in one multiply, then
//   `ex2.approx`; max and sum over 4 partial chains per row (one chain left
//   the softmax latency-bound), then over the 4 lanes that share a row.
//   Masked scores are -inf and a row with no live key yet keeps m = -inf
//   without NaNs.  Only tiles crossed by the diagonal, the window edge or
//   Skv are masked;
// * o is stored from the accumulator layout with 4-byte stores (no TMA
//   store), through o's strides.
// Sizes against the first sketch of this design: the ring has 3 stages, not
// 2, because with p.v overlapped a stage is held until the next tile's
// softmax ends, so with 2 the producer could not run a tile ahead; the grid
// is persistent, not one block per item, so an item's q load, first k/v
// loads and stores overlap the neighbouring items' products.
// It replaces `flash_fwd_mma` (4 warps, 64 x 64 tiles, `mma.sync`, k/v
// loaded synchronously through registers with two `__syncthreads` a tile).
// f32 (`flash_fwd_fma`, tests and small shapes): the same tiling on the
// f32 FMA units (64 x 64 tiles, 4 warps, one block per (tile, head,
// batch)), so the scores and p.v keep full f32 precision; thread (ty, tx)
// = (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4), score columns
// tx + 8 j (j < 8) and output columns 4 tx + 32 j + e.
//
// Bound on the H100: operations.  With the causal mask the kept FLOPs are
// ~4 * Hq * D * (live scores); at Sq = Skv = 2675, D = 128, Hq = 32 that is
// 5.9e10 FLOP, 59 us at the 989 TFLOP/s bf16 tensor-core rate, against 3.4 MB
// of q, k, v and o (16 us at 3.35 TB/s).  Besides the products, each tile
// costs the k/v tile's 64 KB from L2 into shared memory and 64 exp2 per
// thread of each consumer; the design hides both under the products.
#include <cmath>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element strides of one (B, H, S, D) operand; D is contiguous.
struct Strides {
  long long b, h, s;
};

constexpr int BQ = 64;        // query rows per block (f32 kernel)
constexpr int BKV = 64;       // keys per kv tile (f32 kernel)
constexpr int THREADS = 128;  // 4 warps (f32 kernel)
constexpr int PS = 68;        // row stride of the f32 kernel's probability tile (floats)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D + 4;                 // q/k row stride: conflict-free float4 rows
  static constexpr int KS = QS > PS ? QS : PS;     // the k tile also holds the 64 x PS probabilities
  static constexpr int FLOATS = BQ * QS + BKV * KS + BKV * D;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// The kv range [k_lo, k_hi] the mask lets query rows [q0, q0 + rows)
// reach (empty when k_lo > k_hi).
__device__ __forceinline__ void kv_range(int q0, int rows, int sq, int skv, int causal, int window,
                                         int& k_lo, int& k_hi) {
  const int offset = causal ? skv - sq : 0;
  const int q_last = min(q0 + rows, sq) - 1;
  k_hi = skv - 1;
  k_lo = 0;
  if (causal) {
    k_hi = min(k_hi, q_last + offset);
  } else if (window >= 0) {
    k_hi = min(k_hi, q_last + window - 1);
  }
  if (window >= 0) k_lo = max(0, q0 + offset - window + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
              Strides vs, Strides os, int sq, int skv, int group, int causal, int window,
              float scale) {
  using S = Smem<D>;
  constexpr int QS = S::QS, KS = S::KS;
  constexpr int DJ = D / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x QS
  float* Ks = Qs + BQ * QS;                     // BKV x KS: k, then p
  float* Vs = Ks + BKV * KS;                    // BKV x D

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const long long hk = h / group;
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + hk * ks.h;
  const float* vh = v + b * vs.b + hk * vs.h;
  float* oh = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] = q0 + r < sq ? qh[(q0 + r) * qs.s + c] * scale : 0.f;
  }

  const bool has_window = window >= 0;
  const int offset = causal ? skv - sq : 0;
  int k_lo, k_hi;
  kv_range(q0, BQ, sq, skv, causal, window, k_lo, k_hi);

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
      Ks[r * KS + c] = in ? kh[(t0 + r) * ks.s + c] : 0.f;
      Vs[r * D + c] = in ? vh[(t0 + r) * vs.s + c] : 0.f;
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
    float* row = oh + r * os.s;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[4 * tx + 32 * jj + e] = acc[i][4 * jj + e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA, an mbarrier ring and wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A box of the 4-D tensor map at (col, row, head, batch) into shared memory;
// its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Returns once at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int K>
__device__ __forceinline__ void reg_fence_u32(uint32_t (&r)[N][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128 f32) = or += a (64 x 16, smem, K-major) . b (128 x 16, smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = or += a (64 x 16, smem, K-major) . b (64 x 16, smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

// d (64 x 32 f32) += a (64 x 16 bf16, registers) . b (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += a (64 x 16 bf16, registers) . b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += a (64 x 16 bf16, registers) . b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

// Named barrier `id` over the two consumer warpgroups: one waits (sync)
// for the other's 128 arrivals.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Issues sc (64 x BN per warpgroup) = q (64 x D, at q_base) . k^T (k: BN x D,
// at k_base), D / 16 steps of 16 columns; both K-major, in boxes of SW-byte
// rows q_box / kv_box bytes apart.  Committed, not waited for.
template <int D, int BN, int SW>
__device__ __forceinline__ void qk_tile(float (&sc)[BN / 2], uint32_t q_base, uint32_t k_base,
                                        uint32_t q_box, uint32_t kv_box, uint64_t layout) {
  constexpr int BOX_COLS = SW / 2;
  wgmma_fence();
  reg_fence(sc);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int box = ks * 16 / BOX_COLS, within = (ks * 16 % BOX_COLS) * 2;
    wgmma_ss<BN>(sc, smem_desc(q_base + box * q_box + within, 16, 8 * SW, layout),
                 smem_desc(k_base + box * kv_box + within, 16, 8 * SW, layout), ks > 0);
  }
  wgmma_commit();
  reg_fence(sc);
}

// Issues acc (64 x D per warpgroup) += p (64 x BN, registers) . v (BN x D,
// at v_base): BN / 16 steps of 16 keys; v is MN-major, its boxes kv_box
// bytes apart.  Committed, not waited for.
template <int D, int BN, int SW>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 2], uint32_t (&pa)[BN / 16][4],
                                        uint32_t v_base, uint32_t kv_box, uint64_t layout) {
  wgmma_fence();
  reg_fence(acc);
  reg_fence_u32(pa);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (D == 256) {  // two n128 halves: columns [0, 128) are boxes 0-1, [128, 256) 2-3
      float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
      float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&acc[64]);
      wgmma_rs_n128(lo, pa[kk], smem_desc(v_base + kk * 16 * SW, kv_box, 8 * SW, layout));
      wgmma_rs_n128(hi, pa[kk], smem_desc(v_base + 2 * kv_box + kk * 16 * SW, kv_box, 8 * SW, layout));
    } else {
      wgmma_rs<D>(acc, pa[kk], smem_desc(v_base + kk * 16 * SW, kv_box, 8 * SW, layout));
    }
  }
  wgmma_commit();
  reg_fence(acc);
}

// p (f32, the s accumulator's layout) to the bf16 A operand of p.v: the
// m16n8 accumulator layout of two 8-key column blocks is the A fragment of
// one 16-key step.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scales one tile of scores into the log2 domain, masks it where `edge`
// (the tile crosses the diagonal, the window's edge or Skv), and runs the
// online-softmax update of this lane's rows row0 (half 0) and row0 + 8:
// sc becomes p, m and l are updated, alpha rescales the accumulator.  Max
// and sum run over 4 partial chains per row, so their latencies overlap.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, bool edge,
                                             int t0, int row0, int t, int sq, int skv,
                                             int causal, int window) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
  if (edge) {
    const bool has_window = window >= 0;
    const int offset = causal ? skv - sq : 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + 8 * j + 2 * t + (e & 1);
        const int qp = row0 + 8 * (e >> 1);
        bool ok = kp < skv;
        if (causal) {
          ok = ok && kp <= qp + offset;
          if (has_window) ok = ok && kp > qp + offset - window;
        } else if (has_window) {
          ok = ok && abs(kp - qp) < window;
        }
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
    }
  }
  // sc[4 j + e]: row half e / 2; partial chain j % 4.
  float mx[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[half][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1][j & 3] = fmaxf(mx[e >> 1][j & 3], sc[4 * j + e]);
  float m_use[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = fmaxf(fmaxf(mx[half][0], mx[half][1]), fmaxf(mx[half][2], mx[half][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[half], v);
    m_use[half] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: p = 0, no NaN
    alpha[half] = fast_exp2(m[half] - m_use[half]);
    m[half] = m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(sc[4 * j + e] - m_use[e >> 1]);
      sc[4 * j + e] = p;
      sum[e >> 1][j & 3] += p;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)  // this lane's share; the quad sums at the end
    l[half] = l[half] * alpha[half] + ((sum[half][0] + sum[half][1]) + (sum[half][2] + sum[half][3]));
}

template <int D>
struct Tiles {
  static constexpr int BM = 128;              // query rows per item: two consumer warpgroups of 64
  // D = 256: 128-key tiles in 3 stages would need 448 KB; 64-key tiles in 2
  // stages take q 64 KB + 2 x (k 32 KB + v 32 KB) = 192 KB.
  static constexpr int BN = D > 128 ? 64 : 128;  // keys per kv tile
  static constexpr int STAGES = D > 128 ? 2 : 3;  // depth of the k/v ring
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // swizzle span = bytes of one box row
  static constexpr int BOX_COLS = SW / 2;     // bf16 columns of one TMA box
  static constexpr int NBOX = D / BOX_COLS;   // boxes per tile row (2 at D = 128)
  static constexpr int Q_BOX = BM * SW;       // bytes of one q box
  static constexpr int KV_BOX = BN * SW;      // bytes of one k or v box
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 + 2 * STAGES);
};

// One work item: 128 query rows of one (batch, head) and the kv tiles the
// mask lets them reach.  Items are numbered heaviest first (under causal
// the last query tiles see the most keys), with the query heads of one kv
// head adjacent, so their k/v tiles are read from L2.
struct Item {
  int b, h, q0, t_first, n_tiles;
};

template <int BM, int BN>
__device__ __forceinline__ Item item_of(int idx, int nb, int hq, int sq, int skv, int causal,
                                        int window) {
  const int m_blocks = (sq + BM - 1) / BM;
  const int per_m = nb * hq;
  Item it;
  const int rest = idx % per_m;
  it.b = rest / hq;
  it.h = rest % hq;
  it.q0 = (m_blocks - 1 - idx / per_m) * BM;
  int k_lo, k_hi;
  kv_range(it.q0, BM, sq, skv, causal, window, k_lo, k_hi);
  it.t_first = k_lo / BN;
  it.n_tiles = k_lo <= k_hi ? k_hi / BN - it.t_first + 1 : 0;
  return it;
}

// The k-th item of block `bid` of a persistent grid of `grid` blocks: a
// snake over the heaviest-first order, so each block's sum of work is close
// to the mean.
__device__ __forceinline__ int item_index(int k, int bid, int grid) {
  return k * grid + ((k & 1) ? grid - 1 - bid : bid);
}

constexpr int WG_THREADS = 128;
constexpr int CONSUMER_WARPS = 8;

template <int D>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, Strides os,
                int nb, int hq, int sq, int skv, int group, int causal, int window,
                float scale_log2) {
  using T = Tiles<D>;
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, SW = T::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Ks = Qs + T::Q_BYTES;            // STAGES tiles
  uint8_t* Vs = Ks + STAGES * T::KV_BYTES;  // STAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * T::KV_BYTES);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + STAGES;
  const int n_items = (sq + BM - 1) / BM * nb * hq;
  const int grid = gridDim.x, bid = blockIdx.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // Producer: one thread keeps q and the k/v ring full, item after item.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // tiles loaded so far: ring slot it % STAGES, round it / STAGES
      for (int k = 0, idx = bid; idx < n_items; idx = item_index(++k, bid, grid)) {
        const Item item = item_of<BM, BN>(idx, nb, hq, sq, skv, causal, window);
        const int hk = item.h / group;
        mbar_wait(q_empty, (k & 1) ^ 1);  // the previous item's q.k^T are done
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < T::NBOX; ++c)
          tma_load(Qs + c * T::Q_BOX, &tq, q_full, c * T::BOX_COLS, item.q0, item.h, item.b);
        for (int i = 0; i < item.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + s, 2 * T::KV_BYTES);
          const int row = (item.t_first + i) * BN;
#pragma unroll
          for (int c = 0; c < T::NBOX; ++c) {
            tma_load(Ks + s * T::KV_BYTES + c * T::KV_BOX, &tk, full + s, c * T::BOX_COLS, row, hk,
                     item.b);
            tma_load(Vs + s * T::KV_BYTES + c * T::KV_BOX, &tv, full + s, c * T::BOX_COLS, row, hk,
                     item.b);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c takes query rows [64 c, 64 c + 64) of each item.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_base = smem_u32(Qs) + 64 * c * SW;
    const bool has_window = window >= 0;
    const int offset = causal ? skv - sq : 0;
    // Ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2), so one's softmax runs while the
    // other's products are on the tensor cores.  Warpgroup 0 goes first;
    // the turns run on across items.
    const int own_bar = 1 + c, other_bar = 2 - c;
    if (c == 0) named_arrive(own_bar);

    int it = 0;  // tiles consumed so far, as the producer counts them
    for (int k = 0, idx = bid; idx < n_items; idx = item_index(++k, bid, grid)) {
      const Item item = item_of<BM, BN>(idx, nb, hq, sq, skv, causal, window);
      const int qa = item.q0 + 64 * c;       // this warpgroup's first row
      const int row0 = qa + 16 * warp + g;   // this lane's rows: row0 and row0 + 8
      const int n_tiles = item.n_tiles;
      auto edge_of = [&](int t0) {  // does the mask cut this tile for these rows?
        bool edge = t0 + BN > skv;
        if (causal) {
          edge = edge || t0 + BN - 1 > qa + offset;
          if (has_window) edge = edge || t0 <= qa + 63 + offset - window;
        } else if (has_window) {
          edge = edge || t0 + BN - 1 - qa >= window || qa + 63 - t0 >= window;
        }
        return edge;
      };
      auto release_q = [&]() {  // this warp's q.k^T of the item are done
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      };

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float sc[BN / 2];          // scores of the current tile, then its p in f32
      uint32_t pa[BN / 16][4];   // p of the previous tile, bf16: the A operand of p.v
      float alpha[2];

      // Tile j's q.k^T is issued with tile j-1's p.v, and tile j's softmax
      // runs while that p.v is on the tensor cores.
      mbar_wait(q_full, k & 1);
      if (n_tiles == 0) release_q();
      if (n_tiles > 0) {
        const int s = it % STAGES;
        mbar_wait(full + s, (it / STAGES) & 1);
        named_sync(own_bar);
        qk_tile<D, BN, SW>(sc, q_base, smem_u32(Ks + s * T::KV_BYTES), T::Q_BOX, T::KV_BOX,
                           T::LAYOUT);
        named_arrive(other_bar);
        wgmma_wait<0>();
        reg_fence(sc);
        if (n_tiles == 1) release_q();
        const int t0 = item.t_first * BN;
        softmax_tile<BN>(sc, m, l, alpha, scale_log2, edge_of(t0), t0, row0, t, sq, skv, causal,
                         window);
        pack_p<BN>(pa, sc);
      }
      for (int i = 1; i < n_tiles; ++i) {
        const int s = (it + i) % STAGES, sp = (it + i - 1) % STAGES;
        mbar_wait(full + s, ((it + i) / STAGES) & 1);
        named_sync(own_bar);
        qk_tile<D, BN, SW>(sc, q_base, smem_u32(Ks + s * T::KV_BYTES), T::Q_BOX, T::KV_BOX,
                           T::LAYOUT);
        pv_tile<D, BN, SW>(acc, pa, smem_u32(Vs + sp * T::KV_BYTES), T::KV_BOX, T::LAYOUT);
        named_arrive(other_bar);
        wgmma_wait<1>();  // q.k^T of tile i is done; p.v of tile i - 1 runs on
        reg_fence(sc);
        if (i == n_tiles - 1) release_q();
        const int t0 = (item.t_first + i) * BN;
        softmax_tile<BN>(sc, m, l, alpha, scale_log2, edge_of(t0), t0, row0, t, sq, skv, causal,
                         window);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence_u32(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + sp);  // this warp is done with tile i - 1's stage
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= alpha[0];
          acc[4 * n + 1] *= alpha[0];
          acc[4 * n + 2] *= alpha[1];
          acc[4 * n + 3] *= alpha[1];
        }
        pack_p<BN>(pa, sc);
      }
      if (n_tiles > 0) {  // the last tile's p.v
        const int sp = (it + n_tiles - 1) % STAGES;
        pv_tile<D, BN, SW>(acc, pa, smem_u32(Vs + sp * T::KV_BYTES), T::KV_BOX, T::LAYOUT);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence_u32(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + sp);
      }
      it += n_tiles;

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = l[half];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = row0 + 8 * half;
        if (r >= sq) continue;
        const float inv = 1.f / (sum == 0.f ? 1.f : sum);
        __nv_bfloat16* row = o + item.b * os.b + item.h * os.h + r * os.s + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(row + 8 * n) =
              pack_f32(acc[4 * n + 2 * half] * inv, acc[4 * n + 2 * half + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (the library does not
// link libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                    &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, H, rows, D) bf16 view as a 4-D tensor map of boxes of box_cols x
// box_rows, swizzled by the box row's span.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int d, int rows, int heads,
            int batch, Strides st, int box_cols, int box_rows, int sw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2, static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int nb, hq, sq, skv, group, causal, window;
  float scale;
};

template <int D>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_fma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.nb);
  flash_fwd_fma<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks, a.vs, a.os, a.sq,
      a.skv, a.group, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using T = Tiles<D>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int hkv = a.hq / a.group;
  if (!encode(fn, &tq, a.q, D, a.sq, a.hq, a.nb, a.qs, T::BOX_COLS, T::BM, T::SW) ||
      !encode(fn, &tk, a.k, D, a.skv, hkv, a.nb, a.ks, T::BOX_COLS, T::BN, T::SW) ||
      !encode(fn, &tv, a.v, D, a.skv, hkv, a.nb, a.vs, T::BOX_COLS, T::BN, T::SW))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  // Persistent: one block per SM (shared memory allows no second), each
  // walking its share of the items.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>((a.sq + T::BM - 1) / T::BM) * a.nb * a.hq;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  flash_fwd_wgmma<D><<<blocks, 3 * WG_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.os, a.nb, a.hq, a.sq, a.skv, a.group,
      a.causal, a.window, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(const Args& a, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_wgmma<D>(a, stream) : launch_fma<D>(a, stream);
}

}  // namespace

// q (nb, hq, sq, d), k/v (nb, hq / group, skv, d), o (nb, hq, sq, d), each
// given by its base and its (batch, head, row) element strides, the last
// dim contiguous; one type for all (is_bf16 ? bf16 : f32).  The bf16 kernel
// needs the strides in multiples of 16 bytes and 16-byte aligned bases (the
// wrapper checks).  window < 0 means none.  Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a head dim other than 32,
// 64, 128, 256 or a view no tensor map takes).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               long long qsb, long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh, long long oss, int nb,
                               int hq, int sq, int skv, int d, int group, int causal, int window,
                               float scale, int is_bf16, void* stream) {
  if (nb <= 0 || hq <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, o, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
               nb, hq, sq, skv, group, causal, window, scale};
  cudaError_t err;
  switch (d) {
    case 32: err = launch_typed<32>(a, is_bf16, st); break;
    case 64: err = launch_typed<64>(a, is_bf16, st); break;
    case 128: err = launch_typed<128>(a, is_bf16, st); break;
    case 256: err = launch_typed<256>(a, is_bf16, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of the kernel for head dim d (bf16 or
// f32), in bytes; -1 for a head dim it does not take.
extern "C" int flash_attention_smem_bytes(int d, int is_bf16) {
  switch (d) {
    case 32: return static_cast<int>(is_bf16 ? Tiles<32>::SMEM : Smem<32>::BYTES);
    case 64: return static_cast<int>(is_bf16 ? Tiles<64>::SMEM : Smem<64>::BYTES);
    case 128: return static_cast<int>(is_bf16 ? Tiles<128>::SMEM : Smem<128>::BYTES);
    case 256: return static_cast<int>(is_bf16 ? Tiles<256>::SMEM : Smem<256>::BYTES);
    default: return -1;
  }
}
