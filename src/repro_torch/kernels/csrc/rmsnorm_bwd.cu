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
// written once.  The design moves each byte once, keeps many rows in
// flight, and is one launch:
//
// - A row team of L lanes owns one row at a time; lane t holds the row's
//   16-byte vectors t, t + L, ... (VPT of them) of x and dy between the two
//   sums (x.x and x.w.dy) and the writing of dx.  The team's next kDepth
//   rows are in flight meanwhile: each lane copies its own vectors of them
//   with cp.async into the team's ring of rows in shared memory and waits
//   on its own copy groups, so the ring costs no registers and needs no
//   barrier.  The copies carry an L2 evict-first hint: x and dy are read
//   once, and the L2 keeps dx's lines and the workspace instead.  (A
//   prefetch of one row into registers, the design before this one, timed
//   no faster than the two-launch kernel it replaced.)
// - Wide rows (more than 32 x kNarrowVecs vectors) take teams of whole
//   warps at kVecs vectors a lane (4 past 8 warps x kVecs), reduced by
//   shuffles and the team's own named barrier, so the CTA's teams never
//   wait on each other.  Narrow rows (bf16 d <= 512 at the default) take
//   teams of kMinLanes to 32 lanes, several rows a warp, each reduced by
//   shuffles inside its segment.
// - A CTA of up to kThreads threads holds kThreads / L teams (at Yi's
//   width 2 teams of 8 warps, 16 warps on the SM), which walk the rows on
//   a persistent grid: row block blockIdx.x, + gridDim.x, ...
// - Each lane keeps fp32 partial sums of dw for its columns across all its
//   team's rows.  At the end they are combined in a fixed order: the
//   segments of a warp by shuffles, the warps or teams of the CTA through
//   shared memory in index order, into one fp32 workspace row per CTA.
//   (Clusters of 2 CTAs first combining their rows through distributed
//   shared memory, which halves the workspace, timed 6 to 7% slower.)
//   Then every CTA meets at a
//   grid-wide barrier, and the CTAs sum disjoint kStripe-column stripes of
//   the workspace over its rows in row order and cast to w's dtype.  dw's
//   bits never depend on which CTA ends first.
// - The barrier is an arrival counter and a generation word in a small
//   device buffer that the caller owns: the last arrival sets the counter
//   back to 0 and advances the generation, so the next call, and every
//   replay of a CUDA graph that captured this one, starts from 0.  A
//   barrier over CTAs that are not all resident would hang, so the grid is
//   sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor at first use,
//   and a launch asking for more is
//   refused; a wait of seconds traps, so a barrier that never opens fails
//   the launch and does not hang the device.  Two launches must not run at
//   once on one device with one counter (the wrapper keeps one per stream).
//
// The knobs below were chosen by timing in turns on an H100 80GB HBM3 at
// 700 W (experiments/torch_rmsnorm_bwd_turns.py --variant; PERF.md, PR 22).
// Widths up to 8 warps x 4 vectors a lane (bf16 d <= 8192, fp32 d <= 4096).
// C interface (ctypes): returns a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---- knobs (experiments/torch_rmsnorm_bwd_turns.py --variant) --------------
constexpr int kThreads = 512;      // threads a CTA at up to 2 vectors a lane: its teams together
constexpr int kThreadsVpt4 = 256;  // ... at 4 vectors a lane (room for 255 registers)
constexpr int kDepth = 2;          // rows of each team in flight ahead of the one it reduces
constexpr int kVecs = 2;           // vectors a lane at wide rows up to 8 warps x kVecs (2 or 4)
constexpr int kNarrowVecs = 2;     // vectors a lane at most at narrow rows (1, 2 or 4)
constexpr int kMinLanes = 8;       // lanes of the narrowest row segment (1 to 32, a power of 2)
constexpr int kCtasPerSm = 1;      // resident CTAs an SM, at most (occupancy caps it)
constexpr int kStripe = 32;        // dw columns a CTA sums at a time after the barrier
constexpr int kBatch = 16;         // ... with this many partial rows a thread in flight
constexpr int kEvictFirst = 1;     // x and dy copied with an L2 evict-first hint (read once)
constexpr int kMaxTeamWarps = 8;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a plan may ask for
constexpr unsigned kSpinLimit = 1u << 24;  // polls of the barrier (seconds) before a trap
constexpr int kMaxWarps = kThreads / 32;
static_assert(kVecs == 2 || kVecs == 4, "kVecs: 2 or 4");
static_assert(kNarrowVecs == 1 || kNarrowVecs == 2 || kNarrowVecs == 4, "kNarrowVecs: 1, 2 or 4");
static_assert(kMinLanes >= 1 && kMinLanes <= 32 && (kMinLanes & (kMinLanes - 1)) == 0,
              "kMinLanes: a power of 2 up to 32");
static_assert(kThreads % 256 == 0 && kThreads <= 1024 && kThreadsVpt4 % 256 == 0, "threads");
static_assert(kDepth >= 1 && kDepth <= 7, "kDepth: 1 to 7 (cp.async.wait_group's immediate)");

template <int VPT> constexpr int max_threads() { return VPT == 4 ? kThreadsVpt4 : kThreads; }

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

// N floats as one vector of T (bf16 rounded in pairs: one cvt a pair).
template <typename T>
__device__ __forceinline__ Vec<T> pack(const float (&o)[Vec<T>::N]) {
  Vec<T> v;
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) v.v[j] = o[j];
  return v;
}
template <>
__device__ __forceinline__ Vec<__nv_bfloat16> pack<__nv_bfloat16>(const float (&o)[8]) {
  Vec<__nv_bfloat16> v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(v.v);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The row's two sums on every lane of its team of L lanes.  L <= 32: a
// segment of its warp (aligned, L a power of 2), shuffles inside it.  L > 32:
// W = L / 32 whole warps, shuffles, then the team's barrier and shuffles
// over its warp sums; `part` is this row's half of the double buffer.  Every
// thread of the CTA calls it.
__device__ __forceinline__ void team_sum2(float& a, float& b, int L,
                                          float (*part)[kMaxWarps]) {
  if (L <= 32) {
    for (int off = L >> 1; off > 0; off >>= 1) {  // inside the row's segment
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    return;
  }
  const int W = L >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  // the team's own barrier (ids 1 to 15; 0 is __syncthreads'), so the
  // CTA's teams do not wait on each other
  asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / W), "r"(L) : "memory");
  const int first = warp - warp % W;
  a = warp_sum(lane < W ? part[0][first + lane] : 0.f);
  b = warp_sum(lane < W ? part[1][first + lane] : 0.f);
}

// 16 bytes from global to shared memory, asynchronously (cp.async, L2 only),
// with the L2 policy `policy` where kEvictFirst is set.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned long long policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (kEvictFirst)
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(gmem), "l"(policy) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
}

// The grid-wide barrier on bar[0] (arrivals) and bar[1] (generation).
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
// `gen` is bar[1] as thread 0 read it at the kernel's start (the arrival's
// release keeps that read before it): it moves only after every CTA has
// arrived.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // the CTA's writes are ordered before its arrival by the barrier above
    // and the arrival's release; the others' after the wait by its acquire
    if (atom_add_acq_rel(bar, 1u) == gridDim.x - 1) {  // the last arrival
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(bar), "r"(0u) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar + 1), "r"(1u)
                   : "memory");
    } else {
      for (unsigned n = 0; ld_acquire(bar + 1) == gen; ++n)
        if (n == kSpinLimit) __trap();  // a barrier that never opens fails the launch
    }
  }
  __syncthreads();
}

// dx for every row, dw summed over all rows: one launch (see the top).
// blockDim.x = R teams x L lanes.  Dynamic shared memory: first the ring of
// rows, [kDepth + 1 slots][R teams][x, dy][nvec vectors]; after the walk
// the same bytes hold the partial dw rows of the CTA's units (warps at L <
// 32, teams otherwise), [units][d] fp32; at least blockDim.x floats.
template <typename T, int VPT>
__global__ void __launch_bounds__(max_threads<VPT>())
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                   T* __restrict__ dx, T* __restrict__ dw, float* __restrict__ ws,
                   unsigned* __restrict__ bar, int T_rows, int d, int L, float eps) {
  using V = Vec<T>;
  constexpr int N = V::N, S = kDepth + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  V* ring = reinterpret_cast<V*>(smem_raw);
  __shared__ float part[2][2][kMaxWarps];
  const int tid = threadIdx.x, R = blockDim.x / L;
  const int team = tid / L, lt = tid - team * L;
  const int nvec = d / N;
  const unsigned gen = tid == 0 ? ld_relaxed(bar + 1) : 0u;  // the grid barrier's, early

  float wf[VPT][N], acc[VPT][N];  // w of the lane's columns; its share of dw
  const V* wr = reinterpret_cast<const V*>(w);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * L + lt;
    V wv;
    if (i < nvec) wv = wr[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wf[k][j] = i < nvec ? to_f32(wv.v[j]) : 0.f;
      acc[k][j] = 0.f;
    }
  }

  // Each lane copies its own vectors of a row into the team's ring slot and
  // later reads back only those, so no barrier guards the ring: the lane's
  // wait on its own copy groups is enough.
  // x and dy are read once: their lines go first when the L2 needs room,
  // which keeps dx's and the workspace's there
  unsigned long long policy = 0;
  if (kEvictFirst)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  auto copy_row = [&](int slot, int row) {
    const V* xr = reinterpret_cast<const V*>(x + (size_t)row * d);
    const V* gr = reinterpret_cast<const V*>(dy + (size_t)row * d);
    V* dst = ring + (size_t)(slot * R + team) * 2 * nvec;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = k * L + lt;
      if (i < nvec) {
        cp_async16(dst + i, xr + i, policy);
        cp_async16(dst + nvec + i, gr + i, policy);
      }
    }
  };
  // the CTA's row blocks of R rows, blockIdx.x, + gridDim.x, ...: a loop
  // the whole CTA runs alike, a team whose row is past the end idling
  // through it; kDepth rows of each team in flight ahead of the one it
  // reduces, one copy group a row (empty past the end)
  const int stride = gridDim.x * R;
  int row = blockIdx.x * R + team;
#pragma unroll
  for (int p = 0; p < kDepth; ++p) {
    const long long r = (long long)row + (long long)p * stride;
    if (r < T_rows) copy_row(p, (int)r);
    cp_async_commit();
  }
  for (int it = 0, base = blockIdx.x * R; base < T_rows; ++it, base += stride, row += stride) {
    const long long next = (long long)row + (long long)kDepth * stride;
    if (next < T_rows) copy_row((it + kDepth) % S, (int)next);  // in flight while this row reduces
    cp_async_commit();
    cp_async_wait<kDepth>();  // this row's group has landed
    const bool live = row < T_rows;
    float xf[VPT][N], gf[VPT][N], wg[VPT][N];  // x, dy and w * dy of the lane's columns
    float ss = 0.f, sd = 0.f;  // sum x^2, sum x * w * dy
    if (live) {
      const V* src = ring + (size_t)((it % S) * R + team) * 2 * nvec;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = k * L + lt;
        if (i < nvec) {
          const V xv = src[i], gv = src[nvec + i];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            xf[k][j] = to_f32(xv.v[j]);
            gf[k][j] = to_f32(gv.v[j]);
            wg[k][j] = wf[k][j] * gf[k][j];
            ss += xf[k][j] * xf[k][j];
            sd += xf[k][j] * wg[k][j];
          }
        }
      }
    }
    team_sum2(ss, sd, L, part[it & 1]);
    if (live) {
      const float r = rsqrtf(ss / (float)d + eps);
      const float c = r * r * r * (sd / (float)d);
      V* out = reinterpret_cast<V*>(dx + (size_t)row * d);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = k * L + lt;
        if (i < nvec) {
          float o[N];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            o[j] = r * wg[k][j] - xf[k][j] * c;
            acc[k][j] += gf[k][j] * (xf[k][j] * r);
          }
          out[i] = pack<T>(o);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes become the units' dw rows

  // ---- dw: the CTA's partial row, in unit order -----------------------------
  if (L < 32) {  // the warp's segments hold the same columns: add them up
#pragma unroll
    for (int k = 0; k < VPT; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j)
        for (int off = L; off < 32; off <<= 1)
          acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], off);
  }
  const int unit_lanes = L < 32 ? 32 : L;
  const int units = blockDim.x / unit_lanes, unit = tid / unit_lanes;
  if (tid - unit * unit_lanes < L) {
    float4* mine = reinterpret_cast<float4*>(smem + (size_t)unit * d);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = k * L + lt;
      if (i < nvec) {  // 16 bytes a store: a lane's N columns without bank conflicts
#pragma unroll
        for (int j = 0; j < N; j += 4)
          mine[(i * N + j) / 4] =
              make_float4(acc[k][j], acc[k][j + 1], acc[k][j + 2], acc[k][j + 3]);
      }
    }
  }
  __syncthreads();
  float* out = ws + (size_t)blockIdx.x * d;
  for (int c = tid; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int u = 0; u < units; ++u) s += smem[(size_t)u * d + c];  // in unit order
    out[c] = s;
  }

  grid_barrier(bar, gen);

  // ---- dw: stripes of kStripe columns, summed over the rows in row order ----
  const int rows = gridDim.x, Y = blockDim.x / kStripe;
  const int y = tid / kStripe, cx = tid - y * kStripe;
  const int chunk = (rows + Y - 1) / Y;
  const int r0 = y * chunk;
  const int r1 = min(r0 + chunk, rows);  // this thread's share of the partial rows
  for (int s0 = blockIdx.x * kStripe; s0 < d; s0 += gridDim.x * kStripe) {
    const int col = s0 + cx;
    float s = 0.f;
    if (col < d)
      for (int rb = r0; rb < r1; rb += kBatch) {  // kBatch loads in flight, added in row order
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          v[q] = rb + q < r1 ? __ldcg(ws + (size_t)(rb + q) * d + col) : 0.f;
#pragma unroll
        for (int q = 0; q < kBatch; ++q) s += v[q];
      }
    smem[tid] = s;
    __syncthreads();
    if (y == 0 && col < d) {
      float total = 0.f;
      for (int q = 0; q < Y; ++q) total += smem[q * kStripe + cx];  // the shares in order
      dw[col] = from_f32<T>(total);
    }
    __syncthreads();
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

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// How a call runs: its instance (VPT), lanes a team, threads and dynamic
// shared memory a CTA, and the grid.
struct Plan {
  int vpt, lanes, threads, smem, grid;
};

template <typename T, int VPT>
cudaError_t resident_ctas(int threads, int smem, int* out) {
  // CTAs of this instance that fit the device at once, by (device, threads, smem)
  struct Entry { int dev, threads, smem, ctas; };
  static Entry cache[64];
  static int n = 0;
  static bool ceiling_set[64] = {false};
  const int dev = current_device();
  auto kernel = rmsnorm_bwd_kernel<T, VPT>;
  if (!ceiling_set[dev]) {  // once: every plan's dynamic shared memory fits under it
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return e;
    ceiling_set[dev] = true;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (cache[i].dev == dev && cache[i].threads == threads && cache[i].smem == smem) {
      *out = cache[i].ctas;
      return cudaSuccess;
    }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const int ctas = (per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * sm_count();
  if (ctas < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (n < 64) cache[n++] = {dev, threads, smem, ctas};
  *out = ctas;
  return cudaSuccess;
}

template <typename T>
cudaError_t plan(int T_rows, int d, Plan* p) {
  const int nvec = d / Vec<T>::N;
  int need;
  if (nvec <= 32 * kNarrowVecs) {  // narrow: a segment of a warp a row
    int L = kMinLanes;
    while (L * kNarrowVecs < nvec) L *= 2;
    p->lanes = L;
    need = ceil_div(nvec, L);
  } else {  // wide: whole warps a row
    const int v = nvec <= 32 * kMaxTeamWarps * kVecs ? kVecs : 4;
    const int W = ceil_div(nvec, 32 * v);
    if (W > kMaxTeamWarps) return cudaErrorInvalidValue;
    p->lanes = 32 * W;
    need = v;
  }
  p->vpt = need <= 1 ? 1 : need <= 2 ? 2 : 4;
  const int cap = p->vpt == 4 ? kThreadsVpt4 : kThreads;
  int teams = cap / p->lanes > 1 ? cap / p->lanes : 1;
  if (p->lanes > 32 && teams > 15) teams = 15;  // a named barrier each (ids 1 to 15)
  const int slot = 2 * d * (int)sizeof(T);      // x and dy of one row
  while (teams > 1 && (kDepth + 1) * teams * slot > kMaxSmem) --teams;
  p->threads = teams * p->lanes;
  const int units = p->threads / (p->lanes < 32 ? 32 : p->lanes);
  const int ring = (kDepth + 1) * teams * slot;
  int floats = units * d;
  if (floats < p->threads) floats = p->threads;
  p->smem = ring > floats * (int)sizeof(float) ? ring : floats * (int)sizeof(float);
  int resident = 0;
  cudaError_t e = p->vpt == 1   ? resident_ctas<T, 1>(p->threads, p->smem, &resident)
                  : p->vpt == 2 ? resident_ctas<T, 2>(p->threads, p->smem, &resident)
                                : resident_ctas<T, 4>(p->threads, p->smem, &resident);
  if (e != cudaSuccess) return e;
  const int want = ceil_div(T_rows, teams);
  p->grid = want < resident ? want : resident;
  return cudaSuccess;
}

template <typename T, int VPT>
cudaError_t launch_instance(const Plan& p, const void* x, const void* w, const void* dy,
                            void* dx, void* dw, void* ws, void* bar, int blocks, int T_rows,
                            int d, float eps, cudaStream_t s) {
  int resident = 0;
  cudaError_t e = resident_ctas<T, VPT>(p.threads, p.smem, &resident);
  if (e != cudaSuccess) return e;
  // a barrier over CTAs that are not all resident would never open
  if (blocks > resident) return cudaErrorCooperativeLaunchTooLarge;
  rmsnorm_bwd_kernel<T, VPT><<<blocks, p.threads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<T*>(dw), static_cast<float*>(ws),
      static_cast<unsigned*>(bar), T_rows, d, p.lanes, eps);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* ws,
                   void* bar, int blocks, int T_rows, int d, float eps, cudaStream_t s) {
  Plan p;
  cudaError_t e = plan<T>(T_rows, d, &p);
  if (e != cudaSuccess) return e;
  switch (p.vpt) {
    case 1: return launch_instance<T, 1>(p, x, w, dy, dx, dw, ws, bar, blocks, T_rows, d, eps, s);
    case 2: return launch_instance<T, 2>(p, x, w, dy, dx, dw, ws, bar, blocks, T_rows, d, eps, s);
    default:
      return launch_instance<T, 4>(p, x, w, dy, dx, dw, ws, bar, blocks, T_rows, d, eps, s);
  }
}

bool valid(int T_rows, int d, int dtype) {
  return T_rows > 0 && d > 0 && d % 8 == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// How a call runs: out[0] = blocks (the grid, and the rows of its fp32
// workspace), out[1] = threads a CTA, out[2] = lanes a row team, out[3] =
// dynamic shared memory a CTA in bytes.  dtype codes (of x, w, dy, dx and
// dw alike): 0 = float32, 1 = bfloat16.
extern "C" int rmsnorm_bwd_plan(int T_rows, int d, int dtype, int* out) {
  if (!valid(T_rows, d, dtype)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e =
      dtype == 0 ? plan<float>(T_rows, d, &p) : plan<__nv_bfloat16>(T_rows, d, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.grid;
  out[1] = p.threads;
  out[2] = p.lanes;
  out[3] = p.smem;
  return 0;
}

// ws is an fp32 workspace of [blocks, d], bar two uint32 words that are 0
// before the first call and that no other launch uses meanwhile; blocks as
// rmsnorm_bwd_plan gives it (a larger grid than fits the device at once is
// refused).  x, w, dy and dx must be 16-byte aligned
// (the wrapper checks).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw, void* ws, void* bar, int blocks, int T_rows, int d,
                                  float eps, int dtype, void* stream) {
  if (!valid(T_rows, d, dtype) || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch<float>(x, w, dy, dx, dw, ws, bar, blocks, T_rows, d, eps, s)
                 : launch<__nv_bfloat16>(x, w, dy, dx, dw, ws, bar, blocks, T_rows, d, eps, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
