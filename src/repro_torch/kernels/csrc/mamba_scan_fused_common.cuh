// Device code shared by csrc/mamba_scan_fused.cu (the forward) and
// csrc/mamba_scan_fused_bwd.cu (the backward) of the selective scan from the
// layer's own inputs: the terms' formation and the state update, rounded as
// the plain version (ref.scan_terms_ref) rounds them on the card, the
// readout's in-thread sum, and the staging of tiles in shared memory by
// cp.async.  Both sources form a_t, b_t and h_t through these functions
// alone, so the forward's states and the backward's recomputed ones are the
// same bits.
//
// Rounding: a_t = exp(dt_t A) is the product dt A, then expf (PyTorch's exp
// of a float, not __expf); b_t = (dt_t x_t) B_t is dt x, then times B; the
// update is a multiply, then an add.  Every product and sum is __fmul_rn or
// __fadd_rn, so nothing is contracted into a fused multiply-add.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_fused {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a_t of one state: exp of the product dt A
__device__ __forceinline__ float term_a(float dt, float A) { return expf(__fmul_rn(dt, A)); }
// dt x of one channel, which b_t = (dt x) B_t scales
__device__ __forceinline__ float term_dx(float dt, float x) { return __fmul_rn(dt, x); }
// h_t = a_t h_{t-1} + (dt x) B_t
__device__ __forceinline__ float update(float a, float h, float dx, float b) {
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(dx, b));
}
// one step of a thread's P states, from dt, dt x and the step's B values
template <int P>
__device__ __forceinline__ void advance(float (&h)[P], const float (&ac)[P], float dtv,
                                        float dx, const float (&bv)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) h[j] = update(term_a(dtv, ac[j]), h[j], dx, bv[j]);
}

// a thread's P values s[L j] as floats
template <typename T, int P>
__device__ __forceinline__ void load_p(const T* s, int L, float (&out)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = to_f(s[L * j]);
}

// the sum of a thread's P terms in the butterfly's in-thread levels: j with
// j + P/2 first, then j + P/4, ... (the lanes' levels follow by shuffles)
template <int P>
__device__ __forceinline__ float tree(float (&v)[P]) {
#pragma unroll
  for (int h = P / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) v[j] = __fadd_rn(v[j], v[j + h]);
  }
  return v[0];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// s[u][c] = g[b, t0 + u, d0 + c] of a [B, S, di] tensor for u < Steps, 0
// outside it; the CTA's Threads threads share the copies
template <int Steps, int Threads, typename T>
__device__ __forceinline__ void stage_rows(T* s, const T* g, int bi, int t0, int S, int di,
                                           int d0, int CH, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int vpr = CH / E;
    for (int i = threadIdx.x; i < Steps * vpr; i += Threads) {
      const int u = i / vpr, v = i - u * vpr;
      const int t = t0 + u, dd = d0 + v * E;
      const bool in = t < S && dd < di;
      cp_async16(s + u * CH + v * E, in ? g + ((int64_t)bi * S + t) * di + dd : g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Steps * CH; i += Threads) {
      const int u = i / CH, c = i - u * CH;
      const int t = t0 + u, dd = d0 + c;
      s[i] = t < S && dd < di ? g[((int64_t)bi * S + t) * di + dd] : from_f<T>(0.f);
    }
  }
}

// s[u][n] = g[b, t0 + u, n] of a [B, S, N] tensor for u < Steps, 0 past S
template <int Steps, int Threads, typename T>
__device__ __forceinline__ void stage_states(T* s, const T* g, int bi, int t0, int S, int N,
                                             bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int64_t base = ((int64_t)bi * S + t0) * N;
  const int left = (S - t0) * N;  // elements of the batch row from t0 on
  if (vec) {
    for (int i = threadIdx.x; i < Steps * N / E; i += Threads) {
      const int o = i * E;
      const int bytes = o + E <= left ? 16 : o < left ? (left - o) * (int)sizeof(T) : 0;
      cp_async16(s + o, bytes ? g + base + o : g, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < Steps * N; i += Threads) {
      s[i] = i < left ? g[base + i] : from_f<T>(0.f);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace scan_fused
