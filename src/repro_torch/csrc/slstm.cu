// Kernel 7: the sLSTM recurrence with exponential gating, forward.
//
// Replaces the Pallas kernel `slstm_sequence` (src/repro/kernels/slstm.py,
// `_kernel`).  For every (b, h) and t in order, with the recurrent weights
// r[h] (4, hd, hd) and the state c, n, h, m (hd each):
//   pre_t = pre[b, h, t] + h . r[h]           (4, hd), the gates i f z o
//   m' = max(f~ + m, i~)
//   i  = exp(i~ - m'),  f = exp(f~ + m - m')
//   c' = f c + i tanh(z~),  n' = f n + i,  h' = sigmoid(o~) c' / max(n', 1)
// and writes every h' to hs and the last c, n, h, m.  f32 throughout; r is
// f32 or bf16 (the serving copy), widened exactly when it is staged.
//
// Why not one block per (b, h), as the TPU kernel keeps r[h] in VMEM: at
// hd = 512, r[h] is 4 MB in f32 (2 MB in bf16), and a block has at most
// 227 KB of shared memory.  Streaming r[h] from L2 at every step would move
// megabytes per step through one SM.
//
// Design: one persistent launch per call that keeps r on chip for the whole
// sequence.
// * Each (b, h) is split over P blocks by hidden unit: block p owns the
//   U = hd / P units [j0, j0 + U) and all four gates of them, and keeps
//   r[h, :, :, j0:j0+U] in shared memory as 4U rows ("columns" c = gate*U+j)
//   of hd values (row stride hd + 4, so the 16-byte (f32) and 8-byte (bf16)
//   row loads of neighbouring columns fall in distinct banks).  At hd = 512,
//   U = 16, P = 32: 128 KB in f32, 64 KB in bf16.
// * Each step reads the whole h_{t-1} (hd floats) into shared memory;
//   thread (col, ks) sums the products of its column over the k-split ks
//   (hd / KS terms, 4 at a time); the KS partials are added in shared
//   memory, the pre-activation added, and thread j < U updates unit j's
//   state, which stays in its registers for the whole sequence.
// * h_t travels between the P blocks of a (b, h) through a double-buffered
//   global exchange buffer (2, B*H, hd), chosen by step parity, read with
//   L2 loads (ld.global.cg), and a barrier per (b, h) group: a counter in
//   global memory (zeroed by the wrapper), released with __threadfence +
//   atomicAdd, acquired by spinning until it reaches P (t + 1).  The buffer
//   of step t is overwritten at step t + 2 only, after every block of the
//   group passed barrier t + 1, i.e. after it read step t's h.
// * A spin barrier needs every block of the group resident at once, so
//   a sequence of more than one step is launched with
//   cudaLaunchCooperativeKernel, which refuses a grid that cannot be; the
//   entry point launches at most (resident blocks) / P groups at a time,
//   batch slice by batch slice.  One step (decode) reaches no barrier and
//   is launched in one ordinary launch.
// * The pre-activation of step t + 1 is loaded while step t runs.
// expf, tanhf and 1 / (1 + expf(-x)) without fast-math; m0 = -1e30 gives
// f = 0 at the first step, as in the reference.
//
// Bound on the H100: operations.  8 hd^2 FLOP per (b, h, step) on the f32
// units (67 TFLOP/s): at S = 2675, B = 1, H = 4, hd = 512 that is 2.24e10
// FLOP, 0.335 ms, against 118 MB of pre, hs and bf16 r (0.035 ms at
// 3.35 TB/s).  The S dependent steps, each with an exchange through L2 and
// a barrier, set a floor this bound does not see.  Thread-block clusters
// that broadcast h through distributed shared memory are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_UNITS = 16;  // units per block: 4 * 16 = 64 columns, 4 k-splits

struct Args {
  const float* pre;  // pre[b, h, t, g, e] at b*pre_sb + h*pre_sh + t*pre_st + g*pre_sg + e
  long long pre_sb, pre_sh, pre_st, pre_sg;
  const void* r;  // (H, 4, hd, hd) contiguous, f32 or bf16
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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
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

size_t smem_bytes(int hd, int units, size_t r_elem) {
  const int cols = 4 * units, ks = THREADS / cols;
  return static_cast<size_t>(cols) * (hd + 4) * r_elem +
         static_cast<size_t>(hd + ks * cols + cols) * sizeof(float);
}

template <typename R>
__global__ void __launch_bounds__(THREADS) slstm_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int U = a.U, hd = a.hd, C = 4 * U, KS = THREADS / C, RS = hd + 4;
  R* Rs = reinterpret_cast<R*>(smem4);                         // C x RS
  float* hsm = reinterpret_cast<float*>(Rs + static_cast<size_t>(C) * RS);  // hd
  float* red = hsm + hd;                                       // KS x C
  float* gsm = red + KS * C;                                   // C

  const int tid = threadIdx.x;
  const int g = a.group0 + blockIdx.x / a.P;  // flattened (b, h)
  const int j0 = (blockIdx.x % a.P) * U;
  const int b = g / a.H, h = g % a.H;

  // Stage r[h, gate, :, j0:j0+U] as rows c = gate * U + j.
  const R* r = static_cast<const R*>(a.r) + static_cast<size_t>(h) * 4 * hd * hd;
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
  const R* row = Rs + static_cast<size_t>(col) * RS;
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

template <typename R>
cudaError_t launch_typed(Args a, cudaStream_t stream) {
  int units = MAX_UNITS;
  while (a.hd % units) units >>= 1;
  int max_smem = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  while (units > 4 && smem_bytes(a.hd, units, sizeof(R)) > static_cast<size_t>(max_smem)) units >>= 1;
  const size_t smem = smem_bytes(a.hd, units, sizeof(R));
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(slstm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  a.U = units;
  a.P = a.hd / units;
  if (a.S <= 1) {  // no barrier is reached: any grid works
    a.group0 = 0;
    slstm_kernel<R><<<a.groups * a.P, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slstm_kernel<R>, THREADS, smem);
  if (err != cudaSuccess) return err;
  const int per_launch = per_sm * sms / a.P;  // groups resident at once
  if (per_launch < 1) return cudaErrorCooperativeLaunchTooLarge;
  for (int g0 = 0; g0 < a.groups; g0 += per_launch) {
    const int ng = a.groups - g0 < per_launch ? a.groups - g0 : per_launch;
    a.group0 = g0;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(slstm_kernel<R>),
                                      dim3(ng * a.P), dim3(THREADS), params, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// pre (B, H, S, 4, hd) f32 with the given element strides (unit stride 1),
// r (H, 4, hd, hd) contiguous (r_bf16 ? bf16 : f32), c0/n0/h0/m0 and
// cf/nf/hf/mf (B, H, hd) f32 contiguous, hs (B, H, S, hd) f32 with the given
// strides, xbuf (2, B*H, hd) f32 scratch, counters (B*H,) zeroed.  hd must be
// a multiple of 4.  Returns cudaGetLastError()
// of the launches (cudaErrorInvalidValue for an hd the kernel does not take).
extern "C" int slstm_sequence(const void* pre, long long pre_sb, long long pre_sh,
                              long long pre_st, long long pre_sg, const void* r, int r_bf16,
                              const void* c0, const void* n0, const void* h0, const void* m0,
                              void* hs, long long hs_sb, long long hs_sh, long long hs_st,
                              void* cf, void* nf, void* hf, void* mf, void* xbuf,
                              void* counters, int batch, int heads, int seq, int hd,
                              void* stream) {
  if (hd <= 0 || hd % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.pre = static_cast<const float*>(pre);
  a.pre_sb = pre_sb;
  a.pre_sh = pre_sh;
  a.pre_st = pre_st;
  a.pre_sg = pre_sg;
  a.r = r;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = r_bf16 ? launch_typed<__nv_bfloat16>(a, st) : launch_typed<float>(a, st);
  return static_cast<int>(err);
}
