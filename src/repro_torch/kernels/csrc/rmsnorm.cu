// Fused RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel `rmsnorm_kernel` / `rmsnorm_pallas` of
// src/repro/kernels/rmsnorm.py, which keeps a block of whole rows resident
// in VMEM.  It computes the same thing: (x_f32 * rsqrt(mean(x_f32^2) + eps))
// * w_f32, cast to x's dtype.
//
// Bound on the H100: bytes.  Per row it reads d values of x and writes d,
// against ~4 flops per value, far below the ~295 flop/byte ridge; w (d
// values) is read once per CTA.  So the design moves each byte once, in
// 16-byte vectors, and keeps enough of them in flight:
//
// - A CTA of W warps (1 to 16) owns one row at a time; thread t holds the
//   row's vectors t, t + 32W, ... (at most VPT, a compile-time count of 2
//   or 4) in registers between the sum of squares and the scaling, so x is
//   read from memory once.  w is read once per CTA, as the same vectors,
//   kept in registers across all the CTA's rows.
// - The fp32 sum of squares is reduced by warp shuffles, then in one block
//   step: each warp's sum goes to shared memory (double-buffered by row
//   parity, so one barrier per row suffices) and every warp reduces the W
//   sums with shuffles again.
// - With enough rows to fill the card (T >= 2 x SMs), the grid is
//   persistent: at most kCtasPerSm resident CTAs per SM walk the rows (row
//   += gridDim.x), each of W = ceil(d / (8 or 4 values x 32 x
//   kVecsPerThread)) warps, and the next row is loaded into registers
//   before the current one reduces, so its copy is in flight meanwhile.
// - With few rows (the decode step's T = 4), time is latency: one CTA per
//   row, one thread per vector up to 256 threads, at most 4 vectors a
//   thread.
// - Widths beyond 16 warps x 4 vectors (bf16 d > 16384, fp32 d > 8192; no
//   config gives RMSNorm such a width) take a general kernel that loops
//   over the row, reading it a second time (from L2) to scale it.
//
// The knobs below were chosen by timing in turns at x[2048,4096] bf16 on
// an H100 80GB HBM3 at 700 W (experiments/torch_rmsnorm_turns.py --variant;
// PERF.md section 6, the redesign's chip run 4): 2 CTAs per SM lost by
// 12.2% cold; 2 vectors a thread were within the spread.  The register
// prefetch beat a 2- or 3-deep ring of rows copied by cp.async.bulk onto an
// mbarrier (by 10.7 to 15.4% cold, 10.7 to 20.8% warm, same run), which was
// then removed.
//
// C interface (ctypes): every function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// resident CTAs per SM of the persistent grid (capped by occupancy)
constexpr int kCtasPerSm = 4;
// 16-byte vectors a thread holds at many rows (2 or 4)
constexpr int kVecsPerThread = 4;
constexpr int kMaxWarps = 16;
constexpr int kGeneralThreads = 512;

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
__device__ __forceinline__ float sum_sq(const Vec<T>& a) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) {
    const float f = to_f32(a.v[j]);
    s += f * f;
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The row's sum of squares on every thread of the CTA's W warps: warp
// shuffles, then one barrier and shuffles over the W warp sums.  `part` is
// this row's half of the double buffer.
__device__ __forceinline__ float block_sum(float s, float* part) {
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31;
  s = warp_sum(s);
  if (lane == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  return warp_sum(lane < W ? part[lane] : 0.f);
}

// out row = (x * r) * w, the reference's association, from registers.
template <typename T, int VPT>
__device__ __forceinline__ void store_row(T* __restrict__ out_row, const Vec<T> (&xv)[VPT],
                                          const Vec<T> (&wv)[VPT], float r, int nvec) {
  Vec<T>* o = reinterpret_cast<Vec<T>*>(out_row);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * blockDim.x + threadIdx.x;
    if (i < nvec) {
      Vec<T> ov;
#pragma unroll
      for (int j = 0; j < Vec<T>::N; ++j)
        ov.v[j] = from_f32<T>(to_f32(xv[k].v[j]) * r * to_f32(wv[k].v[j]));
      o[i] = ov;
    }
  }
}

// ---- the kernels ----------------------------------------------------------

// blockDim.x / 32 warps per row, VPT vectors a thread; rows blockIdx.x,
// + gridDim.x, ...
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
             int T_rows, int d, float eps) {
  using V = Vec<T>;
  const int threads = blockDim.x;
  const int nvec = d / V::N;
  const int tid = threadIdx.x;
  __shared__ float part[2][kMaxWarps];

  V wv[VPT];
  const V* wr = reinterpret_cast<const V*>(w);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * threads + tid;
    if (i < nvec) wv[k] = wr[i];
  }

  auto load = [&](V (&dst)[VPT], int row) {
    const V* xr = reinterpret_cast<const V*>(x + (size_t)row * d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = k * threads + tid;
      if (i < nvec) dst[k] = xr[i];
    }
  };
  V cur[VPT];
  int row = blockIdx.x;
  if (row < T_rows) load(cur, row);
  for (int it = 0; row < T_rows; ++it, row += gridDim.x) {
    V nxt[VPT];
    const long long next = (long long)row + gridDim.x;
    if (next < T_rows) load(nxt, (int)next);  // in flight while this row reduces
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (k * threads + tid < nvec) s += sum_sq(cur[k]);
    s = block_sum(s, part[it & 1]);
    store_row<T, VPT>(out + (size_t)row * d, cur, wv, rsqrtf(s / (float)d + eps), nvec);
#pragma unroll
    for (int k = 0; k < VPT; ++k) cur[k] = nxt[k];
  }
}

// Any width: one CTA per row, the row read twice (the second time from L2).
template <typename T>
__global__ void __launch_bounds__(kGeneralThreads)
rmsnorm_general(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                int d, float eps) {
  using V = Vec<T>;
  const int nvec = d / V::N;
  const V* xr = reinterpret_cast<const V*>(x + (size_t)blockIdx.x * d);
  const V* wr = reinterpret_cast<const V*>(w);
  V* o = reinterpret_cast<V*>(out + (size_t)blockIdx.x * d);
  __shared__ float part[kGeneralThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kGeneralThreads) s += sum_sq(xr[i]);
  const float r = rsqrtf(block_sum(s, part) / (float)d + eps);
  for (int i = threadIdx.x; i < nvec; i += kGeneralThreads) {
    const V xv = xr[i], wv = wr[i];
    V ov;
#pragma unroll
    for (int j = 0; j < V::N; ++j) ov.v[j] = from_f32<T>(to_f32(xv.v[j]) * r * to_f32(wv.v[j]));
    o[i] = ov;
  }
}

// ---- launch -----------------------------------------------------------------

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < 64 ? dev : 0;
}

int sm_count() {
  static int cached[64] = {0};
  const int dev = current_device();
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

template <typename T, int VPT>
cudaError_t launch_rows(const T* x, const T* w, T* out, int T_rows, int d, float eps,
                        int warps, bool persistent, cudaStream_t stream) {
  auto kernel = rmsnorm_rows<T, VPT>;
  int grid = T_rows;
  if (persistent) {
    // resident CTAs per SM, by device and warps, for this instantiation
    static int resident[64][kMaxWarps + 1] = {{0}};
    int& r = resident[current_device()][warps];
    if (!r) {
      cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, warps * 32, 0);
      if (e != cudaSuccess) return e;
      if (r < 1) return cudaErrorInvalidConfiguration;
    }
    const int cap = sm_count() * (r < kCtasPerSm ? r : kCtasPerSm);
    if (grid > cap) grid = cap;
  }
  kernel<<<grid, warps * 32, 0, stream>>>(x, w, out, T_rows, d, eps);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* xp, const void* wp, void* outp, int T_rows, int d, float eps,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* out = static_cast<T*>(outp);
  const int nvec = d / Vec<T>::N;
  auto ceil_div = [](int a, int b) { return (a + b - 1) / b; };
  // Many rows: the fewest warps that hold a row at kVecsPerThread vectors a
  // thread.  Few: one thread per vector up to 256, as one CTA per row had.
  // Either way at most 4 vectors a thread.
  const bool persistent = T_rows >= 2 * sm_count();
  int warps = persistent ? ceil_div(nvec, 32 * kVecsPerThread)
                         : (nvec < 256 ? ceil_div(nvec, 32) : 8);
  if (warps < ceil_div(nvec, 32 * 4)) warps = ceil_div(nvec, 32 * 4);
  if (warps > kMaxWarps) {
    rmsnorm_general<T><<<T_rows, kGeneralThreads, 0, s>>>(x, w, out, d, eps);
    return cudaSuccess;
  }
  return ceil_div(nvec, 32 * warps) <= 2
             ? launch_rows<T, 2>(x, w, out, T_rows, d, eps, warps, persistent, s)
             : launch_rows<T, 4>(x, w, out, T_rows, d, eps, warps, persistent, s);
}

}  // namespace

// dtype codes (of x, w and out alike): 0 = float32, 1 = bfloat16.  x, w and
// out must be 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int T_rows, int d,
                              float eps, int dtype, void* stream) {
  if (T_rows <= 0 || d <= 0 || d % 8 != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch<float>(x, w, out, T_rows, d, eps, s)
                                   : launch<__nv_bfloat16>(x, w, out, T_rows, d, eps, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
