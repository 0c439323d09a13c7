// Selective scan (Mamba-1 recurrence) from the layer's own inputs, for
// Hopper (sm_90a):
//   a_t = exp(dt_t A),  b_t = (dt_t x_t) B_t        formed in registers
//   h_t = a_t * h_{t-1} + b_t                        elementwise over [B, di, N]
//   y_t[d] = sum_n h_t[d, n] * C_t[n]
// from dt, x [B, S, di] and B, C [B, S, N] (all bfloat16 or all float32),
// A [di, N] float32 and an optional h0 [B, di, N] float32, returning y
// [B, S, di] and h_last [B, di, N] float32.
//
// The redesign of csrc/mamba_scan.cu, which replaces the TPU kernel
// `mamba_scan_kernel` / `mamba_scan_pallas` of src/repro/kernels/mamba_scan.py
// at its interface: formed terms a, b [B, S, di, N] float32 in.  The model
// formed those only to feed the kernel (1.07 GB each at Falcon-Mamba-7B's
// prefill of 4 x 512, di 8192, N 16).  Here they never exist: a step reads
// two values of each channel (dt, x) and 2 N values shared by every channel
// of a batch row (B_t, C_t), 16 times fewer bytes than a_t and b_t.
//
// Bound on the H100: operations.  The least traffic (dt, x, B, C, A read
// once, y and h_last written once) is ~0.14 GB at the prefill shape, 0.041
// ms; the work is ~12 float32 operations and one exp per state element and
// step (268 M of them at either of Falcon's shapes), ~0.05 ms at the CUDA
// cores' 67 TFLOP/s and more on the special-function units, which take an
// exp at a quarter of the rate.  So the design keeps the loop on registers
// and shared memory and away from latency:
//
//   * a CTA owns the channels [d0, d0 + CH) of one batch row; each thread
//     owns P = min(N, kStatesPerThread) states of one channel in registers,
//     n = sub + L j for j < P, and the L = N / P threads of a channel (sub
//     = 0 .. L-1) sit in adjacent lanes;
//   * the CTA stages tiles of kSteps steps of its dt and x columns and of
//     the batch row's B and C in shared memory with cp.async, kStages
//     tiles in flight, so the recurrence reads only shared memory (B_t and
//     C_t as broadcasts) and registers;
//   * the readout sums P products in the thread and log2(L) shuffles across
//     its channel's lanes (2 at N 16), where the unfused kernel took 4, in
//     the order of a butterfly over the N states (pairs N/2 apart first,
//     then N/4, ...: the in-thread levels pair j with j + P/2, ...), the
//     order in which the unfused kernel's sum agreed with the plain
//     version's bit for bit.
//
// Rounding: the terms are formed as the plain version forms them on the
// card (ref.scan_terms_ref: the product dt A, then expf, which is PyTorch's
// exp of a float; dt x, then times B), with __fmul_rn so that nothing is
// contracted into a fused multiply-add, and the update is a multiply and
// then an add (term_a, term_dx and update in mamba_scan_fused_common.cuh,
// which the backward's recomputation shares).  So h and h_last agree with
// the plain version bit for bit; y agrees too where PyTorch sums the N
// products in that butterfly order.
//
// Sizes: any S, every N that divides 32, any di.  cp.async takes 16-byte
// vectors: where a row of dt or x (di elements) or a batch row of B and C
// (S N elements) is no whole number of vectors, or a pointer is not
// 16-byte aligned, the tiles are staged by plain loads (the same tiles, the
// same arithmetic).
//
// C interface (ctypes): the launch returns cudaGetLastError().

#include "mamba_scan_fused_common.cuh"

namespace {

using namespace scan_fused;

constexpr int kThreads = 128;
constexpr int kStatesPerThread = 4;  // states of one channel a thread holds
constexpr int kSteps = 64;           // steps of a staged tile
constexpr int kStages = 2;           // tiles in shared memory: one in use, one landing

// The stage of tile k: dt and x [kSteps][CH], then B and C [kSteps][N].
template <typename T>
__device__ __forceinline__ void stage_tile(T* st, const T* dt, const T* x, const T* Bm,
                                           const T* Cm, int bi, int k, int S, int di, int N,
                                           int d0, int CH, bool vec) {
  const int t0 = k * kSteps;
  stage_rows<kSteps, kThreads>(st, dt, bi, t0, S, di, d0, CH, vec);
  stage_rows<kSteps, kThreads>(st + kSteps * CH, x, bi, t0, S, di, d0, CH, vec);
  stage_states<kSteps, kThreads>(st + 2 * kSteps * CH, Bm, bi, t0, S, N, vec);
  stage_states<kSteps, kThreads>(st + 2 * kSteps * CH + kSteps * N, Cm, bi, t0, S, N, vec);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
mamba_scan_fused_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ A, const float* __restrict__ h0,
                        float* __restrict__ y, float* __restrict__ h_last, int S, int di, int N,
                        int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stages = reinterpret_cast<T*>(smem);
  const int L = N / P;        // lanes of one channel
  const int CH = kThreads / L;  // channels of the CTA
  const int stage_elems = kSteps * (2 * CH + 2 * N);
  const int cl = threadIdx.x / L, sub = threadIdx.x % L;  // channel; states sub + L j
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + cl;
  // A lane past di still runs the loop (its lanes' shuffles need it) on the
  // zeros staged for it, and stores nothing.  L divides 32, so the lanes of
  // a channel are all live or all dead.
  const bool live = d < di;
  const int64_t hrow = ((int64_t)bi * di + d) * N + sub;  // h0 and h_last, at + L j

  float ac[P], h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    ac[j] = live ? A[(int64_t)d * N + sub + L * j] : 0.f;
    h[j] = live && h0 != nullptr ? h0[hrow + L * j] : 0.f;
  }
  const int nk = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage_tile(stages + s * stage_elems, dt, x, Bm, Cm, bi, s, S, di, N, d0, CH, vec);
    cp_async_commit();
  }
  float* const yp = y + (int64_t)bi * S * di + d;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    __syncthreads();               // everyone's; and tile k - 1's stage is free
    const int kn = k + kStages - 1;
    if (kn < nk) {
      stage_tile(stages + (kn % kStages) * stage_elems, dt, x, Bm, Cm, bi, kn, S, di, N, d0,
                 CH, vec);
    }
    cp_async_commit();
    const T* const sdt = stages + (k % kStages) * stage_elems;
    const T* const sx = sdt + kSteps * CH;
    const T* const sB = sx + kSteps * CH;
    const T* const sC = sB + kSteps * N;
    const int t0 = k * kSteps;
    const int steps = min(kSteps, S - t0);
#pragma unroll 4
    for (int u = 0; u < steps; ++u) {
      const float dtv = to_f(sdt[u * CH + cl]);
      const float dx = term_dx(dtv, to_f(sx[u * CH + cl]));
      float bv[P], cv[P];
      load_p<T, P>(sB + u * N + sub, L, bv);
      load_p<T, P>(sC + u * N + sub, L, cv);
      advance(h, ac, dtv, dx, bv);
#pragma unroll
      for (int j = 0; j < P; ++j) cv[j] = __fmul_rn(h[j], cv[j]);  // the readout's terms
      float p = tree(cv);
      for (int off = L >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (live && sub == 0) yp[(int64_t)(t0 + u) * di] = p;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < P; ++j) h_last[hrow + L * j] = h[j];
  }
}

template <typename T, int P>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
           const float* h0, float* y, float* h_last, int B, int S, int di, int N, bool vec,
           cudaStream_t stream) {
  const int CH = kThreads / (N / P);
  const int64_t ctas = (di + CH - 1) / CH;
  if (ctas > 2147483647LL || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)kStages * kSteps * (2 * CH + 2 * N) * sizeof(T);
  auto kernel = mamba_scan_fused_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)ctas, (unsigned)B), kThreads, bytes, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, y, h_last, S, di, N, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
             const float* h0, float* y, float* h_last, int B, int S, int di, int N,
             cudaStream_t stream) {
  const bool vec = aligned16(dt) && aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   (int64_t)di * sizeof(T) % 16 == 0 && (int64_t)S * N * sizeof(T) % 16 == 0;
#define FUSED_CASE(PP) \
  case PP: return launch<T, PP>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, di, N, vec, stream);
  switch (N < kStatesPerThread ? N : kStatesPerThread) {
    FUSED_CASE(1)
    FUSED_CASE(2)
    FUSED_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CASE
}

}  // namespace

// dt, x [B, S, di], B, C [B, S, N] all float32 (dtype 0) or all bfloat16
// (dtype 1); A [di, N], h0 [B, di, N] or NULL, y [B, S, di], h_last [B, di,
// N] float32; all contiguous.  N must divide 32.
extern "C" int mamba_scan_fused_launch(const void* dt, const void* x, const void* Bm,
                                       const void* Cm, const void* A, const void* h0, void* y,
                                       void* h_last, int B, int S, int di, int N, int dtype,
                                       void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > 32 || 32 % N) {
    return (int)cudaErrorInvalidValue;
  }
  const float* fA = static_cast<const float*>(A);
  const float* fh0 = static_cast<const float*>(h0);
  float* fy = static_cast<float*>(y);
  float* fh = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(dt, x, Bm, Cm, fA, fh0, fy, fh, B, S, di, N, s);
    case 1: return dispatch<__nv_bfloat16>(dt, x, Bm, Cm, fA, fh0, fy, fh, B, S, di, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba_scan_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
