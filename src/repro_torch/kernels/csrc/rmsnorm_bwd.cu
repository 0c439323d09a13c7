// RMSNorm backward for Hopper (sm_90a): with r = rsqrt(mean(x^2) + eps),
//
//   dx = r * (w * dy) - x * r^3 * mean(x * w * dy)      (cast to x's dtype)
//   dw = sum over rows of dy * (x * r)                   (fp32, cast to w's)
//
// what `jax.grad` of `rms_norm` (src/repro/models/layers.py) gives; the
// reference has no Pallas kernel for it (its forward's is `rmsnorm_pallas`
// of src/repro/kernels/rmsnorm.py, ported as rmsnorm.cu).
//
// Bound on the H100: bytes.  Per row it reads x and dy and writes dx (3 d
// values) against ~10 flops per value; w is read once per CTA and dw
// written once.  The design, like the forward's, moves each byte once:
//
// - a persistent grid (its size chosen by the caller, who sizes the
//   workspace: 2 CTAs per SM in kernels/rmsnorm_bwd.py) walks the rows
//   (row += gridDim.x); a CTA of W warps owns one row at a time, thread t
//   holding the row's 16-byte vectors t, t + 32W, ... (at most kVecs) of x
//   and dy in registers between the two sums (x.x and x.w.dy, reduced
//   together by warp shuffles and one block step) and the writing of dx;
//   the next row's x and dy are loaded before the current row reduces, so
//   their copies are in flight meanwhile;
// - each thread keeps fp32 partial sums of dw for its columns across all
//   its CTA's rows and writes them once, to row blockIdx.x of an fp32
//   workspace [gridDim.x, d]; a second kernel sums the workspace's rows, in
//   a fixed order (deterministic, no atomics), and casts to w's dtype.
//
// Widths up to 8 warps x 4 vectors (bf16 d <= 8192, fp32 d <= 4096).
// C interface (ctypes): returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVecs = 4;        // 16-byte vectors of x (and of dy) a thread holds
constexpr int kMaxWarps = 8;      // 256 threads: room for 255 registers a thread
constexpr int kSumCols = 32;    // dw columns a CTA of the second kernel sums
constexpr int kSumRows = 8;     // ... with this many threads per column

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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The row's two sums on every thread of the CTA: warp shuffles, then one
// barrier and shuffles over the warps' sums.  `part` is this row's half of
// the double buffer.
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*part)[kMaxWarps]) {
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  a = warp_sum(lane < W ? part[0][lane] : 0.f);
  b = warp_sum(lane < W ? part[1][lane] : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ ws, int T_rows, int d, float eps) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int threads = blockDim.x, tid = threadIdx.x;
  const int nvec = d / N;
  __shared__ float part[2][2][kMaxWarps];

  V wv[kVecs];
  float dw[kVecs][N];
  const V* wr = reinterpret_cast<const V*>(w);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = k * threads + tid;
    if (i < nvec) wv[k] = wr[i];
#pragma unroll
    for (int j = 0; j < N; ++j) dw[k][j] = 0.f;
  }

  auto load = [&](V (&xs)[kVecs], V (&gs)[kVecs], int row) {
    const V* xr = reinterpret_cast<const V*>(x + (size_t)row * d);
    const V* gr = reinterpret_cast<const V*>(dy + (size_t)row * d);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = k * threads + tid;
      if (i < nvec) {
        xs[k] = xr[i];
        gs[k] = gr[i];
      }
    }
  };
  V xc[kVecs], gc[kVecs];
  int row = blockIdx.x;
  if (row < T_rows) load(xc, gc, row);
  for (int it = 0; row < T_rows; ++it, row += gridDim.x) {
    V xn[kVecs], gn[kVecs];
    const long long next = (long long)row + gridDim.x;
    if (next < T_rows) load(xn, gn, (int)next);  // in flight while this row reduces
    float ss = 0.f, sd = 0.f;  // sum x^2, sum x * w * dy
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (k * threads + tid < nvec) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xf = to_f32(xc[k].v[j]);
          ss += xf * xf;
          sd += xf * to_f32(wv[k].v[j]) * to_f32(gc[k].v[j]);
        }
      }
    }
    block_sum2(ss, sd, part[it & 1]);
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * r * r * (sd / (float)d);
    V* out = reinterpret_cast<V*>(dx + (size_t)row * d);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = k * threads + tid;
      if (i < nvec) {
        V ov;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xf = to_f32(xc[k].v[j]), gf = to_f32(gc[k].v[j]);
          ov.v[j] = from_f32<T>(r * (to_f32(wv[k].v[j]) * gf) - xf * c);
          dw[k][j] += gf * (xf * r);
        }
        out[i] = ov;
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
  }

  // this CTA's partial dw, row blockIdx.x of the workspace
  float* wrow = ws + (size_t)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = k * threads + tid;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < N; ++j) wrow[i * N + j] = dw[k][j];
    }
  }
}

// dw[c] = sum of the workspace's `rows` rows at column c, in row order
// within each of kSumRows threads and then over them: kSumCols columns a CTA
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumRows)
rmsnorm_bwd_dw(const float* __restrict__ ws, T* __restrict__ dw, int rows, int d) {
  __shared__ float part[kSumRows][kSumCols];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float s = 0.f;
  if (c < d)
    for (int r = threadIdx.y; r < rows; r += kSumRows) s += ws[(size_t)r * d + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kSumRows; ++y) total += part[y][threadIdx.x];
    dw[c] = from_f32<T>(total);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* ws,
           int blocks, int T_rows, int d, float eps, cudaStream_t s) {
  const int nvec = d / Vec<T>::N;
  int warps = (nvec + 32 * kVecs - 1) / (32 * kVecs);
  if (warps < 1) warps = 1;
  if (warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  rmsnorm_bwd_rows<T><<<blocks, warps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ws), T_rows, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw<T><<<(d + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumRows), 0, s>>>(
      static_cast<const float*>(ws), static_cast<T*>(dw), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes (of x, w, dy, dx and dw alike): 0 = float32, 1 = bfloat16.
// ws is an fp32 workspace of [blocks, d]; blocks (<= T_rows) is the grid of
// the row kernel, chosen by the caller.  x, w, dy and dx must be 16-byte
// aligned (the wrapper checks).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* ws, int blocks, int T_rows, int d, float eps,
                                  int dtype, void* stream) {
  if (T_rows <= 0 || d <= 0 || d % 8 != 0 || blocks <= 0 || blocks > T_rows || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, w, dy, dx, dw, ws, blocks, T_rows, d, eps, s)
                    : launch<__nv_bfloat16>(x, w, dy, dx, dw, ws, blocks, T_rows, d, eps, s);
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
