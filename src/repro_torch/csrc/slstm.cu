// Kernel 7: the sLSTM recurrence with exponential gating, forward.
//
// Replaces the Pallas kernel `slstm_sequence` (src/repro/kernels/slstm.py,
// `_kernel`).  For every (b, h) and t in order, with the recurrent weights
// r[h] (4, hd, hd) and the state c, n, h, m (hd each):
//   pre_t = pre[b, h, t] + h . r[h]           (4, hd), the gates i f z o
//   m' = max(f~ + m, i~)
//   i  = exp(i~ - m'),  f = exp(f~ + m - m')
//   c' = f c + i tanh(z~),  n' = f n + i,  h' = sigmoid(o~) c' / max(n', 1)
// and writes every h' to hs and the last c, n, h, m.  f32 state and gate
// math; expf, tanhf and 1 / (1 + expf(-x)) without fast-math; m0 = -1e30
// gives f = 0 at the first step, as in the reference.
//
// Bound on the H100: operations.  8 hd^2 FLOP per (b, h, step) on the f32
// units (67 TFLOP/s): at S = 2675, B = 1, H = 4, hd = 512 that is 2.24e10
// FLOP, 0.335 ms, against 118 MB of pre, hs and bf16 r (0.035 ms at
// 3.35 TB/s).  The S dependent steps set a floor this bound does not see:
// what each step costs is the latency of one product, one exchange of h
// between the SMs that share a head, and the gate math.
//
// The TPU kernel keeps r[h] in VMEM for the whole sequence.  At hd = 512,
// r[h] is 2 MB in bf16 and 4 MB in f32, so a head is split over several SMs
// by hidden unit, each keeping its slice of r on chip, and h_t is exchanged
// between them at every step.  Two variants, chosen by r's dtype alone:
//
// bf16 r (the serving copy): `slstm_cluster`, one thread-block cluster per
// (head, slice of up to 4 batch rows); one launch covers every head and
// slice (grid P x H x slices, cluster P x 1 x 1).
// * Block p of a cluster of P owns U units [p U, p U + U) (U a multiple of
//   4; P the smallest cluster whose U / 4 warps fit the register budget:
//   P = 16, U = 32 at hd = 512) and holds r[h, :, :, its units] in
//   registers for the whole sequence, as mma.sync.m16n8k16 A fragments
//   (staged once through shared memory, coalesced): warp w owns 16 rows
//   m = 4 gate + u (4 units x 4 gates) over all of K, so no sum crosses
//   warps.  K is permuted inside each 16-wide k-step so that a thread's 4 B
//   values are 4 consecutive k (one 8-byte shared load), and padded with
//   zeros to 16 KS.
// * The product h . r runs on the tensor cores in f32: h is split into
//   hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid), which sum to
//   h exactly, and the parts are B columns n = 2 part + row (2 batch rows an
//   n8 tile, columns 6 and 7 unused).  Each bf16 r times a part is exact in
//   f32; the three part sums are added with two warp shuffles, and a unit's
//   four gates meet in one more (lanes g and g + 4 hold i, z and f, o).
// * h_t travels as its parts: each warp splits its 4 new units and pushes
//   them as one group (hi x 4, mid x 4, lo x 4; 24 bytes) into a
//   double-buffered array in the shared memory of every block of the
//   cluster, itself included, with st.async, which counts the bytes on the
//   receiving block's mbarrier of that buffer; a warp starts step t when
//   the phase of buffer t % 2 holds all rows x hd / 4 groups.  The buffer of
//   step t is overwritten at step t + 2 only: a block pushes h_{t+1} after
//   every block's h_t reached it, and each warp pushes h_t after it read
//   buffer t % 2.  No global memory, counter, spin on L2, cluster-wide
//   barrier or __syncthreads is on the chain (a barrier.cluster with
//   release semantics waits for the block's outstanding global loads and
//   stores, ~1 us a step); the hardware co-schedules a cluster's blocks, so
//   no cooperative launch is needed.  The pre of a step is loaded
//   PRE_DEPTH steps ahead into a ring in shared memory (cp.async).
//
// f32 r: `slstm_coop`, as first written.  A 512-wide head's f32 slice is
// 256 KB a block even over 16 blocks, which fits neither shared memory nor
// registers, so each (b, h) is split over hd / 16 blocks that keep r in
// shared memory and exchange h_t through a double-buffered global buffer
// (2, B*H, hd) with a barrier per (b, h) group (a counter zeroed by the
// wrapper, released with __threadfence + atomicAdd, acquired by spinning);
// the group's blocks must be resident at once, so a sequence of more than
// one step is a cooperative launch, batch slice by batch slice.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 r: the cluster kernel
// ---------------------------------------------------------------------------
constexpr int MAX_CLUSTER = 16;  // the non-portable cluster size limit
constexpr int MAX_HD = 512;
constexpr int REG_FILE = 65536;  // 32-bit registers per SM
constexpr int REG_RESERVE = 64;  // registers a thread needs besides its r fragments
constexpr int PRE_DEPTH = 8;     // steps of pre a gate lane loads ahead

// k-steps of 16 the fragments hold: ceil(hd / 16) rounded up to a power of two.
__host__ __device__ constexpr int k_steps(int hd) {
  int ks = 1;
  while (16 * ks < hd) ks <<= 1;
  return ks;
}

// Warps a block may have with 4 ks registers of r a thread: a power of two
// up to 16 whose threads fit the register file.
__host__ __device__ constexpr int max_warps(int ks) {
  int w = 16;
  while (w > 1 && 32 * w * (4 * ks + REG_RESERVE) > REG_FILE) w >>= 1;
  return w;
}

struct ClusterPlan {
  int ks, P, U, threads, rows, slices;
  size_t smem;
};

ClusterPlan cluster_plan(int hd, int batch) {
  ClusterPlan p;
  p.ks = k_steps(hd);
  const int mw = max_warps(p.ks);
  for (p.P = 1; p.P < MAX_CLUSTER; ++p.P) {
    if ((hd + 4 * p.P - 1) / (4 * p.P) <= mw) break;
  }
  p.U = 4 * ((hd + 4 * p.P - 1) / (4 * p.P));
  p.threads = 32 * (p.U / 4);
  p.rows = batch <= 2 ? 2 : 4;
  p.slices = (batch + p.rows - 1) / p.rows;
  // r slice, 2 buffers of h parts, 2 mbarriers, the pre ring (16 gate
  // lanes a warp)
  p.smem = static_cast<size_t>(4) * hd * p.U * 2 + 2 * static_cast<size_t>(p.rows) * 4 * p.ks * 32 +
           16 + static_cast<size_t>(PRE_DEPTH) * (p.threads / 2) * 16;
  return p;
}

struct ClusterArgs {
  const float* pre;  // pre[b, h, t, g, e] at b*pre_sb + h*pre_sh + t*pre_st + g*pre_sg + e
  long long pre_sb, pre_sh, pre_st, pre_sg;
  const __nv_bfloat16* r;  // (H, 4, hd, hd) contiguous
  const float *c0, *n0, *h0, *m0;  // (B, H, hd) contiguous
  float* hs;  // hs[b, h, t, e] at b*hs_sb + h*hs_sh + t*hs_st + e
  long long hs_sb, hs_sh, hs_st;
  float *cf, *nf, *hf, *mf;  // (B, H, hd) contiguous
  int B, H, S, hd, U;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t peer_address(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// Async stores of one group (hi x 4, mid x 4, lo x 4: 24 bytes) into a
// peer's shared memory, counted on the peer's mbarrier (both addresses
// mapped into the peer).
__device__ __forceinline__ void store_peer(uint32_t addr, const uint32_t (&w)[6], uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               ::"r"(addr + 16), "r"(w[4]), "r"(w[5]), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// Arm the barrier's phase: one arrival that expects `bytes` of async stores.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// bf16 offset of unit u in staged row (gate hd + k) of U units: where U is
// a multiple of 32, the row's 16-byte chunks are XOR-swizzled by k / 4, so
// that the fragment loads of one k-step fall in distinct banks.
__device__ __forceinline__ int staged(int row, int u, int U) {
  const int swz = U % 32 == 0 ? (row >> 2) & 3 : 0;
  return row * U + (((u >> 3) ^ swz) << 3) + (u & 7);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The bits of x's three bf16 parts: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid); hi + mid + lo == x.
__device__ __forceinline__ void split3(float x, uint32_t (&p)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  p[0] = __bfloat16_as_ushort(hi);
  p[1] = __bfloat16_as_ushort(mid);
  p[2] = __bfloat16_as_ushort(lo);
}

// The group of 4 consecutive h values: their hi, mid and lo parts, 2 a word.
__device__ __forceinline__ void pack_parts(float x0, float x1, float x2, float x3, uint32_t (&w)[6]) {
  uint32_t p0[3], p1[3], p2[3], p3[3];
  split3(x0, p0);
  split3(x1, p1);
  split3(x2, p2);
  split3(x3, p3);
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    w[2 * part] = p0[part] | (p1[part] << 16);
    w[2 * part + 1] = p2[part] | (p3[part] << 16);
  }
}

template <int KS, int NT>
__global__ void __launch_bounds__(32 * max_warps(KS), 1) slstm_cluster(ClusterArgs a) {
  constexpr int R = 2 * NT;        // batch rows a cluster carries
  constexpr int G = 4 * KS;        // groups of 4 k a row: hi x 4, mid x 4, lo x 4, 4 unused
  constexpr int BUF = R * G * 16;  // bf16 of one buffer of h parts
  constexpr int CH = (NT == 1 ? 4 : 2) < KS ? (NT == 1 ? 4 : 2) : KS;  // accumulators an n-tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U, hd = a.hd, S = a.S;
  // r slice, 4 hd rows of U | the parts of h_t, 2 x BUF by step parity |
  // 2 mbarriers | the pre ring
  __nv_bfloat16* rst = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hsp = rst + static_cast<size_t>(4) * hd * U;
  float4* ring = reinterpret_cast<float4*>(hsp + 2 * BUF) + 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int P = gridDim.x, rank = blockIdx.x, head = blockIdx.y, b0 = blockIdx.z * R;
  const int rows = a.B - b0 < R ? a.B - b0 : R;
  const int j0 = rank * U;
  const int uv = hd - j0 < U ? (hd - j0 > 0 ? hd - j0 : 0) : U;  // this block's units

  // Stage this block's slice of r as it lies, rows (gate, k) of U units
  // (swizzled: `staged`), with 16-byte cp.async where the row allows and
  // 8-byte ones elsewhere: all in flight, no registers.
  const int nw = uv / 4;  // warps with units
  const int nks = (hd + 15) / 16;
  const uint32_t rst_addr = static_cast<uint32_t>(__cvta_generic_to_shared(rst));
  const __nv_bfloat16* r = a.r + static_cast<size_t>(head) * 4 * hd * hd + j0;
  if (uv % 8 == 0 && U % 8 == 0 && hd % 8 == 0) {
    const int c16 = uv / 8;
    for (int idx = tid; idx < 4 * hd * c16; idx += nthr) {
      const int c = idx % c16, row = idx / c16;
      cp_async16(rst_addr + 2 * staged(row, 8 * c, U), r + static_cast<size_t>(row) * hd + 8 * c);
    }
  } else {
    for (int idx = tid; idx < 4 * hd * nw; idx += nthr) {
      const int c = idx % nw, row = idx / nw;
      cp_async8(rst_addr + 2 * staged(row, 4 * c, U), r + static_cast<size_t>(row) * hd + 4 * c);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  // The parts are zero where no row or unit is (K padding, absent rows);
  // buffer 0 holds those of h0.
  for (int i = tid; i < BUF; i += nthr) reinterpret_cast<uint32_t*>(hsp)[i] = 0u;
  __syncthreads();
  for (int i = tid; i < rows * hd / 4; i += nthr) {
    const int rr = i / (hd / 4), k4 = i % (hd / 4);
    const float* x = a.h0 + (static_cast<size_t>(b0 + rr) * a.H + head) * hd + 4 * k4;
    uint32_t w[6];
    pack_parts(x[0], x[1], x[2], x[3], w);
    uint32_t* dst = reinterpret_cast<uint32_t*>(hsp + (rr * G + k4) * 16);
    for (int q = 0; q < 6; ++q) dst[q] = w[q];
  }
  __syncthreads();

  // A fragments: rows m = g (gate g / 4) and g + 8 (gate 2 + g / 4), unit
  // 4 warp + g % 4; a thread's k-step columns 2t, 2t+1, 2t+8, 2t+9 are the
  // consecutive k = 16 ks + 4t .. + 3 (the B fragment is permuted alike).
  uint32_t af[KS][4];
  {
    const int ua = 4 * warp + (g & 3), g0 = g >> 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      af[ks][0] = af[ks][1] = af[ks][2] = af[ks][3] = 0u;
      const int k = 16 * ks + 4 * t4;
      if (warp < nw && k < hd) {
        uint32_t e[2][4];
#pragma unroll
        for (int gi = 0; gi < 2; ++gi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            e[gi][j] = __bfloat16_as_ushort(rst[staged((g0 + 2 * gi) * hd + k + j, ua, U)]);
        af[ks][0] = e[0][0] | (e[0][1] << 16);
        af[ks][1] = e[1][0] | (e[1][1] << 16);
        af[ks][2] = e[0][2] | (e[0][3] << 16);
        af[ks][3] = e[1][2] | (e[1][3] << 16);
      }
    }
  }

  // B fragment of lane (g, t): column g = 2 part + row (columns 6, 7 read
  // part 0), k = 16 ks + 4t .. + 3, i.e. group 4 ks + t; an absent row
  // reads the last present one.
  int boff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int part = g < 6 ? g >> 1 : 0;
    int row = 2 * nt + (g < 6 ? g & 1 : 0);
    row = row < rows ? row : rows - 1;
    boff[nt] = (row * G + t4) * 16 + 4 * part;
  }

  // The gate lanes: g < 4, t = batch row; unit e = j0 + 4 warp + g.  Each
  // loads its 4 gates of pre PRE_DEPTH steps ahead into a ring in shared
  // memory (cp.async), so no load waits on the chain.  A warp without units
  // (the last block of an uneven split) computes and pushes nothing.
  const int e = j0 + 4 * warp + g;
  const bool warp_units = warp < nw;
  const bool gate_lane = g < 4 && t4 < rows && warp_units;
  const size_t sidx = (static_cast<size_t>(b0 + t4) * a.H + head) * hd + e;
  float c = 0.f, n = 0.f, hv = 0.f, m = 0.f;
  const float* pre_l = a.pre + (b0 + t4) * a.pre_sb + head * a.pre_sh + e;
  float* hs_l = a.hs + (b0 + t4) * a.hs_sb + head * a.hs_sh + e;
  const int ring_lane = 16 * warp + 4 * g + t4, ring_stride = nthr / 2;  // 16 gate lanes a warp
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring + ring_lane));
  auto prefetch = [&](int step) {
    if (step < S) {
      const uint32_t dst = ring_addr + static_cast<uint32_t>((step % PRE_DEPTH) * ring_stride * 16);
      for (int q = 0; q < 4; ++q) cp_async4(dst + 4 * q, pre_l + step * a.pre_st + q * a.pre_sg);
    }
    cp_async_commit();
  };
  if (gate_lane) {
    c = a.c0[sidx];
    n = a.n0[sidx];
    hv = a.h0[sidx];
    m = a.m0[sidx];
    for (int step = 0; step < PRE_DEPTH; ++step) prefetch(step);
  }
  // h_t buffer b of step t >= 1 is complete when its mbarrier's phase
  // (t - 1) / 2 completes: the phase expects the bytes every block pushes.
  const uint32_t hsp_addr = static_cast<uint32_t>(__cvta_generic_to_shared(hsp));
  const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring - 1));
  const uint32_t step_bytes = static_cast<uint32_t>(rows * hd / 4 * 24);
  if (tid == 0) {
    mbar_init(bar_addr);
    mbar_init(bar_addr + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (S > 1) mbar_expect(bar_addr + 8, step_bytes);  // step 1
    if (S > 2) mbar_expect(bar_addr, step_bytes);      // step 2
  }
  // Lane l pushes row 2k + l / 16 of round k to peer l % 16: the parts of
  // this warp's 4 units of h_t, one group (24 bytes).
  const bool push_lane = (lane & 15) < P && warp_units;
  uint32_t peer_h = 0, peer_bar = 0;
  if (push_lane) {
    peer_h = peer_address(hsp_addr, static_cast<uint32_t>(lane & 15)) +
             static_cast<uint32_t>((j0 / 4 + warp) * 32);
    peer_bar = peer_address(bar_addr, static_cast<uint32_t>(lane & 15));
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster is running, staged and armed
  cluster_wait();
  // Nothing to compute or push; the block's other warps receive.  Warp 0
  // always has units (every block of a plan owns some), so tid 0 re-arms.
  if (!warp_units) return;

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gate_lane) {
      cp_async_wait<PRE_DEPTH - 1>();  // step t's pre has landed
      x = ring[(t % PRE_DEPTH) * ring_stride + ring_lane];
    }
    if (t > 0) {
      mbar_wait(bar_addr + 8 * buf, ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < S) mbar_expect(bar_addr + 8 * buf, step_bytes);  // step t + 2
    }
    const __nv_bfloat16* hb = hsp + buf * BUF;
    {
      float acc[NT][CH][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][ch][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < nks) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 bv = *reinterpret_cast<const uint2*>(hb + boff[nt] + 64 * ks);
            mma_bf16(acc[nt][ks % CH], af[ks], bv.x, bv.y);
          }
        }
      }
      // Lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 (part t,
      // rows 0 and 1 of the n-tile): add the accumulators, then the parts.
      float d[NT][4], fo[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = acc[nt][0][i];
#pragma unroll
          for (int ch = 1; ch < CH; ++ch) v += acc[nt][ch][i];
          v = t4 == 3 ? 0.f : v;
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          d[nt][i] = v;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) fo[nt][i] = __shfl_xor_sync(0xffffffffu, d[nt][i], 16);
      if (gate_lane) {
        float it = 0.f, ft = 0.f, zt = 0.f, ot = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int ri = 0; ri < 2; ++ri)
            if (2 * nt + ri == t4) {
              it = d[nt][ri];
              zt = d[nt][2 + ri];
              ft = fo[nt][ri];
              ot = fo[nt][2 + ri];
            }
        it += x.x;
        ft += x.y;
        zt += x.z;
        ot += x.w;
        const float mn = fmaxf(ft + m, it);
        const float ig = expf(it - mn);
        const float fg = expf(ft + m - mn);
        const float z = tanhf(zt);
        const float o = 1.f / (1.f + expf(-ot));
        c = fg * c + ig * z;
        n = fg * n + ig;
        hv = o * c / fmaxf(n, 1.f);
        m = mn;
      }
      if (t + 1 < S) {
        const uint32_t nh = peer_h + static_cast<uint32_t>((buf ^ 1) * BUF * 2);
        const uint32_t nbar = peer_bar + static_cast<uint32_t>(8 * (buf ^ 1));
#pragma unroll
        for (int k = 0; k < R / 2; ++k) {
          if (2 * k < rows) {
            const int row = 2 * k + (lane >> 4);
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = __shfl_sync(0xffffffffu, hv, 4 * u + row);
            if (push_lane && row < rows) {
              uint32_t w[6];
              pack_parts(v[0], v[1], v[2], v[3], w);
              store_peer(nh + static_cast<uint32_t>(row * G * 32), w, nbar);
            }
          }
        }
      }
      if (gate_lane) {
        hs_l[t * a.hs_st] = hv;
        prefetch(t + PRE_DEPTH);  // into the slot just read
      }
    }
  }
  if (gate_lane) {
    a.cf[sidx] = c;
    a.nf[sidx] = n;
    a.hf[sidx] = hv;
    a.mf[sidx] = m;
  }
}

using ClusterKernel = void (*)(ClusterArgs);

template <int NT>
ClusterKernel cluster_kernel_nt(int ks) {
  switch (ks) {
    case 1: return slstm_cluster<1, NT>;
    case 2: return slstm_cluster<2, NT>;
    case 4: return slstm_cluster<4, NT>;
    case 8: return slstm_cluster<8, NT>;
    case 16: return slstm_cluster<16, NT>;
    default: return slstm_cluster<32, NT>;
  }
}

ClusterKernel cluster_kernel(const ClusterPlan& p) {
  return p.rows == 2 ? cluster_kernel_nt<1>(p.ks) : cluster_kernel_nt<2>(p.ks);
}

int max_smem_optin();

// The residency of the last plans queried, so that a call in a serving
// loop sets no attribute and queries no occupancy (one device a process).
struct Placed {
  ClusterKernel kern;
  int P, threads, clusters;
  size_t smem;
};
Placed placed[8];
int placed_next = 0;

// Sets the kernel's attributes and fills the launch configuration; returns
// in *clusters how many such clusters the card holds at once.
cudaError_t cluster_config(const ClusterPlan& p, int heads, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int* clusters) {
  const ClusterKernel kern = cluster_kernel(p);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.P, heads, p.slices);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.P;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  for (const Placed& q : placed) {
    if (q.kern == kern && q.P == p.P && q.threads == p.threads && q.smem == p.smem) {
      *clusters = q.clusters;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // The opt-in limit, not this plan's bytes: a cached plan of the same
  // kernel with more shared memory must still launch.
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_optin());
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kern, cfg);
  if (err != cudaSuccess) return err;
  placed[placed_next] = Placed{kern, p.P, p.threads, *clusters, p.smem};
  placed_next = (placed_next + 1) % 8;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// f32 r: the cooperative kernel
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int MAX_UNITS = 16;  // units per block: 4 * 16 = 64 columns, 4 k-splits

struct Args {
  const float* pre;  // pre[b, h, t, g, e] at b*pre_sb + h*pre_sh + t*pre_st + g*pre_sg + e
  long long pre_sb, pre_sh, pre_st, pre_sg;
  const float* r;  // (H, 4, hd, hd) contiguous
  const float *c0, *n0, *h0, *m0;  // (B, H, hd) contiguous
  float* hs;  // hs[b, h, t, e] at b*hs_sb + h*hs_sh + t*hs_st + e
  long long hs_sb, hs_sh, hs_st;
  float *cf, *nf, *hf, *mf;  // (B, H, hd) contiguous
  float* xbuf;  // (2, B*H, hd): h_t of every group, by step parity
  unsigned* counters;  // (B*H,) zeroed
  int groups, H, S, hd, U, P, group0;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Barrier of the P blocks of one (b, h) group: arrive after this block's
// writes of step t, wait until all P arrived (the counter reaches target).
__device__ __forceinline__ void group_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

size_t smem_bytes(int hd, int units) {
  const int cols = 4 * units, ks = THREADS / cols;
  return static_cast<size_t>(cols) * (hd + 4) * sizeof(float) +
         static_cast<size_t>(hd + ks * cols + cols) * sizeof(float);
}

// Units a block of the cooperative kernel owns: 16, halved until they
// divide hd and the block's shared memory fits.
int coop_units(int hd, int max_smem) {
  int units = MAX_UNITS;
  while (hd % units) units >>= 1;
  while (units > 4 && smem_bytes(hd, units) > static_cast<size_t>(max_smem)) units >>= 1;
  return units;
}

__global__ void __launch_bounds__(THREADS) slstm_coop(Args a) {
  extern __shared__ float4 smem4[];
  const int U = a.U, hd = a.hd, C = 4 * U, KS = THREADS / C, RS = hd + 4;
  float* Rs = reinterpret_cast<float*>(smem4);                  // C x RS
  float* hsm = Rs + static_cast<size_t>(C) * RS;                // hd
  float* red = hsm + hd;                                        // KS x C
  float* gsm = red + KS * C;                                    // C

  const int tid = threadIdx.x;
  const int g = a.group0 + blockIdx.x / a.P;  // flattened (b, h)
  const int j0 = (blockIdx.x % a.P) * U;
  const int b = g / a.H, h = g % a.H;

  // Stage r[h, gate, :, j0:j0+U] as rows c = gate * U + j.
  const float* r = a.r + static_cast<size_t>(h) * 4 * hd * hd;
  for (int idx = tid; idx < C * hd; idx += THREADS) {
    const int j = idx % U, rest = idx / U, d = rest % hd, gate = rest / hd;
    Rs[(gate * U + j) * RS + d] = r[(static_cast<size_t>(gate) * hd + d) * hd + j0 + j];
  }

  const size_t sidx = static_cast<size_t>(g) * hd + j0 + tid;  // this thread's unit (tid < U)
  float c = 0.f, n = 0.f, hv = 0.f, m = 0.f;
  if (tid < U) {
    c = a.c0[sidx];
    n = a.n0[sidx];
    hv = a.h0[sidx];
    m = a.m0[sidx];
  }
  const int col = tid % C, ks = tid / C;
  const float* pre_col = a.pre + b * a.pre_sb + h * a.pre_sh + (col / U) * a.pre_sg + j0 + col % U;
  const float* row = Rs + static_cast<size_t>(col) * RS;
  const float* hprev = a.h0 + static_cast<size_t>(g) * hd;
  float x_next = (ks == 0 && a.S > 0) ? pre_col[0] : 0.f;

  for (int t = 0; t < a.S; ++t) {
    const float xt = x_next;
    if (ks == 0 && t + 1 < a.S) x_next = pre_col[(t + 1) * a.pre_st];
    for (int d = tid; d < hd; d += THREADS) hsm[d] = __ldcg(hprev + d);
    __syncthreads();

    float acc = 0.f;
    for (int d = 4 * ks; d < hd; d += 4 * KS) {
      const float4 w = load4(row + d);
      const float4 x = *reinterpret_cast<const float4*>(hsm + d);
      acc = fmaf(x.x, w.x, acc);
      acc = fmaf(x.y, w.y, acc);
      acc = fmaf(x.z, w.z, acc);
      acc = fmaf(x.w, w.w, acc);
    }
    red[ks * C + col] = acc;
    __syncthreads();
    if (ks == 0) {
      float rec = 0.f;
      for (int k = 0; k < KS; ++k) rec += red[k * C + col];
      gsm[col] = xt + rec;
    }
    __syncthreads();

    float* xout = a.xbuf + (static_cast<size_t>(t & 1) * a.groups + g) * hd;
    if (tid < U) {
      const float it = gsm[tid], ft = gsm[U + tid], zt = gsm[2 * U + tid], ot = gsm[3 * U + tid];
      const float mn = fmaxf(ft + m, it);
      const float ig = expf(it - mn);
      const float fg = expf(ft + m - mn);
      const float z = tanhf(zt);
      const float o = 1.f / (1.f + expf(-ot));
      c = fg * c + ig * z;
      n = fg * n + ig;
      hv = o * c / fmaxf(n, 1.f);
      m = mn;
      a.hs[b * a.hs_sb + h * a.hs_sh + t * a.hs_st + j0 + tid] = hv;
      xout[j0 + tid] = hv;
    }
    hprev = xout;
    if (t + 1 < a.S) group_barrier(a.counters + g, static_cast<unsigned>(a.P) * (t + 1));
  }
  if (tid < U) {
    a.cf[sidx] = c;
    a.nf[sidx] = n;
    a.hf[sidx] = hv;
    a.mf[sidx] = m;
  }
}

int max_smem_optin() {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return max_smem;
}

// Groups the cooperative kernel holds resident at once (0 if none fits).
cudaError_t coop_groups(int P, size_t smem, int* per_launch) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaFuncSetAttribute(slstm_coop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_coop, THREADS, smem);
  *per_launch = per_sm * sms / P;
  return err;
}

cudaError_t launch_coop(Args a, cudaStream_t stream) {
  const int max_smem = max_smem_optin();
  const int units = coop_units(a.hd, max_smem);
  const size_t smem = smem_bytes(a.hd, units);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  a.U = units;
  a.P = a.hd / units;
  int per_launch = 0;
  cudaError_t err = coop_groups(a.P, smem, &per_launch);
  if (err != cudaSuccess) return err;
  if (a.S <= 1) {  // no barrier is reached: any grid works
    a.group0 = 0;
    slstm_coop<<<a.groups * a.P, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (per_launch < 1) return cudaErrorCooperativeLaunchTooLarge;
  for (int g0 = 0; g0 < a.groups; g0 += per_launch) {
    const int ng = a.groups - g0 < per_launch ? a.groups - g0 : per_launch;
    a.group0 = g0;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_coop),
                                      dim3(ng * a.P), dim3(THREADS), params, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// The launch plan of a call, without launching: out[0] the variant (1 the
// cluster kernel, bf16 r; 0 the cooperative kernel, f32 r), out[1] blocks
// per head (the cluster size), out[2] units a block, out[3] threads a
// block, out[4] dynamic shared bytes a block, out[5] batch rows a cluster
// (1 for the cooperative kernel: one (b, h) a group), out[6] batch slices
// (launches of the cooperative kernel for S > 1), out[7] clusters (groups)
// the card holds at once.  Returns a CUDA error code.
extern "C" int slstm_plan(int hd, int r_bf16, int batch, int heads, int* out) {
  if (hd <= 0 || hd % 4 != 0 || batch <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (r_bf16) {
    if (hd > MAX_HD) return static_cast<int>(cudaErrorInvalidValue);
    const ClusterPlan p = cluster_plan(hd, batch);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int clusters = 0;
    const cudaError_t err = cluster_config(p, heads, nullptr, &cfg, &attr, &clusters);
    const int vals[8] = {1, p.P, p.U, p.threads, static_cast<int>(p.smem), p.rows, p.slices, clusters};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return static_cast<int>(err);
  }
  const int units = coop_units(hd, max_smem_optin());
  const size_t smem = smem_bytes(hd, units);
  int per_launch = 0;
  const cudaError_t err = coop_groups(hd / units, smem, &per_launch);
  const int groups = batch * heads;
  const int vals[8] = {0, hd / units, units, THREADS, static_cast<int>(smem), 1,
                       per_launch > 0 ? (groups + per_launch - 1) / per_launch : 0, per_launch};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}

// pre (B, H, S, 4, hd) f32 with the given element strides (unit stride 1),
// r (H, 4, hd, hd) contiguous (r_bf16 ? bf16 : f32), c0/n0/h0/m0 and
// cf/nf/hf/mf (B, H, hd) f32 contiguous, hs (B, H, S, hd) f32 with the given
// strides.  bf16 r takes the cluster kernel (hd a multiple of 4 up to 512;
// xbuf and counters unused, may be null); f32 r the cooperative kernel (hd
// a multiple of 4; xbuf (2, B*H, hd) f32 scratch, counters (B*H,) zeroed).
// Returns cudaGetLastError() of the launch: cudaErrorInvalidValue for an hd
// the kernel does not take, cudaErrorLaunchOutOfResources where the card
// cannot place one cluster of the plan.
extern "C" int slstm_sequence(const void* pre, long long pre_sb, long long pre_sh,
                              long long pre_st, long long pre_sg, const void* r, int r_bf16,
                              const void* c0, const void* n0, const void* h0, const void* m0,
                              void* hs, long long hs_sb, long long hs_sh, long long hs_st,
                              void* cf, void* nf, void* hf, void* mf, void* xbuf,
                              void* counters, int batch, int heads, int seq, int hd,
                              void* stream) {
  if (hd <= 0 || hd % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads <= 0 || seq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_bf16) {
    if (hd > MAX_HD) return static_cast<int>(cudaErrorInvalidValue);
    const ClusterPlan p = cluster_plan(hd, batch);
    ClusterArgs a;
    a.pre = static_cast<const float*>(pre);
    a.pre_sb = pre_sb;
    a.pre_sh = pre_sh;
    a.pre_st = pre_st;
    a.pre_sg = pre_sg;
    a.r = static_cast<const __nv_bfloat16*>(r);
    a.c0 = static_cast<const float*>(c0);
    a.n0 = static_cast<const float*>(n0);
    a.h0 = static_cast<const float*>(h0);
    a.m0 = static_cast<const float*>(m0);
    a.hs = static_cast<float*>(hs);
    a.hs_sb = hs_sb;
    a.hs_sh = hs_sh;
    a.hs_st = hs_st;
    a.cf = static_cast<float*>(cf);
    a.nf = static_cast<float*>(nf);
    a.hf = static_cast<float*>(hf);
    a.mf = static_cast<float*>(mf);
    a.B = batch;
    a.H = heads;
    a.S = seq;
    a.hd = hd;
    a.U = p.U;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int clusters = 0;
    cudaError_t err = cluster_config(p, heads, st, &cfg, &attr, &clusters);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    err = cudaLaunchKernelEx(&cfg, cluster_kernel(p), a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  Args a;
  a.pre = static_cast<const float*>(pre);
  a.pre_sb = pre_sb;
  a.pre_sh = pre_sh;
  a.pre_st = pre_st;
  a.pre_sg = pre_sg;
  a.r = static_cast<const float*>(r);
  a.c0 = static_cast<const float*>(c0);
  a.n0 = static_cast<const float*>(n0);
  a.h0 = static_cast<const float*>(h0);
  a.m0 = static_cast<const float*>(m0);
  a.hs = static_cast<float*>(hs);
  a.hs_sb = hs_sb;
  a.hs_sh = hs_sh;
  a.hs_st = hs_st;
  a.cf = static_cast<float*>(cf);
  a.nf = static_cast<float*>(nf);
  a.hf = static_cast<float*>(hf);
  a.mf = static_cast<float*>(mf);
  a.xbuf = static_cast<float*>(xbuf);
  a.counters = static_cast<unsigned*>(counters);
  a.groups = batch * heads;
  a.H = heads;
  a.S = seq;
  a.hd = hd;
  a.U = a.P = a.group0 = 0;
  return static_cast<int>(launch_coop(a, st));
}
