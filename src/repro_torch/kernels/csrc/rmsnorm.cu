// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel `rmsnorm_kernel` / `rmsnorm_pallas` of
// src/repro/kernels/rmsnorm.py, which keeps a block of whole rows resident
// in VMEM.  Here one CTA owns one row [d]; rows are independent, so the
// grid is simply T CTAs and no state crosses blocks.
//
// Bound on the H100: bytes.  Per row it reads d values of x, d of w (from
// L2 after the first CTAs) and writes d values, against ~3 flops per value,
// far below the ~295 flop/byte ridge.  The design therefore only tries to
// move each byte once and in wide transactions: 16-byte vector loads and
// stores (8 bf16 or 4 fp32 values per thread per access), an fp32 sum of
// squares reduced by warp shuffles and then across warps through shared
// memory.  The second pass re-reads the row (at most 32 KB for fp32 d=8192)
// from L1/L2, not from device memory.
//
// C interface (ctypes): every function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T as one vector.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ out, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int row = blockIdx.x;
  const int nvec = d / N;
  const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + (size_t)row * d);
  Vec<T>* outr = reinterpret_cast<Vec<T>*>(out + (size_t)row * d);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T> xv = xr[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float f = to_f32(xv.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) tot += warp_sums[i];
    inv_rms = rsqrtf(tot / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T> xv = xr[i];
    Vec<T> ov;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // same association as the reference: (x * rsqrt(var + eps)) * w
      ov.v[j] = from_f32<T>(to_f32(xv.v[j]) * r * to_f32(w[i * N + j]));
    }
    outr[i] = ov;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int T_rows, int d, float eps,
            cudaStream_t stream) {
  const int nvec = d / Vec<T>::N;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  rmsnorm_kernel<T><<<T_rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d, eps);
}

}  // namespace

// dtype codes (of x, w and out alike): 0 = float32, 1 = bfloat16.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int T_rows, int d,
                              float eps, int dtype, void* stream) {
  if (T_rows <= 0 || d <= 0 || d % 8 != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch<float>(x, w, out, T_rows, d, eps, s);
  else launch<__nv_bfloat16>(x, w, out, T_rows, d, eps, s);
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
