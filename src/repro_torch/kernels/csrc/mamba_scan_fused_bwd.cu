// Backward of the selective scan from the layer's own inputs, for Hopper
// (sm_90a).  Forward (csrc/mamba_scan_fused.cu):
//   a_t = exp(dt_t A),  b_t = (dt_t x_t) B_t,
//   h_t = a_t * h_{t-1} + b_t,   y_t[d] = sum_n h_t[d, n] * C_t[n],
// from h_{-1} = h0.  Given the cotangents gy [B, S, di] of y and gh_fin
// [B, di, N] of h_last (NULL: zeros), this computes the scan's backward
//   g_t  = gy_t C_t + a_{t+1} g_{t+1}     from t = S-1 (a_S g_S := gh_fin)
//   ga_t = g_t h_{t-1},  gb_t = g_t,  gC_t[n] = sum_d h_t[d, n] gy_t[d],
//   gh0  = a_0 g_0,
// and the chain rule through the terms:
//   gdt = sum_n ga a A + (sum_n gb B) x,   gx = (sum_n gb B) dt,
//   gB_t[n] = sum_d gb (dt x),             gA = sum_{b, t} ga a dt.
// dt, x, B, C are bfloat16 or float32 (all four alike); A, h0, gy, gh_fin
// float32.  gdt, gx, gB and gC are summed in float32 and written once in the
// inputs' dtype; gA and gh0 are float32.
//
// The redesign of csrc/mamba_scan_bwd.cu, which replaces `_scan_bwd`, the
// backward of the custom VJP `selective_scan` in src/repro/models/mamba.py,
// at the TPU kernel's interface (formed terms a, b [B, S, di, N] in; ga, gb
// out, which autograd then took through the terms' formation in a dozen
// elementwise and reduction kernels, ~12 ms a layer at Falcon-Mamba-7B's
// training microbatch [1, 2048, 8192, 16]).  Here nothing of size
// [B, S, di, N] is read or written: a thread recomputes its terms from dt,
// x, B and A wherever it needs them.
//
// Layout, as in the forward: a CTA owns CH channels of one batch row; a
// thread owns P = min(N, kStatesPerThread) states of one channel, n = sub +
// L j, the L = N / P threads of a channel in adjacent lanes; tiles of kSteps
// steps (dt, x, gy columns, B and C rows) are staged in shared memory by
// cp.async, kStages in flight.  Walking backward needs h_{t-1} at every step, so the CTA walks
// the sequence twice:
//
//   pass 1, t forward: stores the state entering every chunk of kChunk
//     steps (a float32 scratch [B, ceil(S / kChunk), di, N]);
//   pass 2, tiles and their chunks from last to first: recomputes a and h
//     through the chunk from the state entering it (kChunk steps of both in
//     registers), then runs g backward over the chunk, carrying g and the
//     chunk's first a into the chunk before it.
//
// Sums, all in a fixed order (no atomics, so two calls give the same bits):
// over n (gdt, gx) in the thread, then log2(L) shuffles across the
// channel's lanes, in the butterfly order of the forward's readout (the
// plain version's order: they agree bit for bit); over the channels (gB,
// gC) each thread writes its terms of a chunk to shared memory, the CTA
// sums them per (t, n) in float64, in 8 interleaved runs over its channels
// added pairwise, and writes one float64 partial to a workspace [B, CTAs of
// a row, S, 2 N]; over t (gA) in registers, a chunk's 8 steps in float32,
// the chunks in float64, each batch row's sum to a workspace [B, di, N] of
// float64.  A second launch sums the partials over the CTAs (gB, gC) and
// over the batch rows (gA) in order, in float64, and rounds once.  So gB
// and gC are the float32 terms' float64 sum within one rounding (with
// float32 partials over 32 channels, gC strayed 1.0e-5 of its row's scale
// from it at one draw of Falcon's microbatch), gA within a few float32
// roundings of exact; the plain version sums gB, gC and gA in float64 too.
//
// Bound on the H100: operations.  The least traffic (dt, x, B, C, A, gy,
// h0, gh_fin read once; gdt, gx, gB, gC, gA, gh0 written once) is ~0.2 GB
// at Falcon's microbatch, 0.06 ms; the work recomputes the forward (an exp
// and ~6 operations a state element and step) and does ~14 more.
//
// Rounding: every term, state and cotangent rounds as the plain version
// (ref.mamba_scan_fused_bwd_ref) computes it on the card: a product, then
// an add, no fused multiply-add; the terms and states through the
// forward's own functions (mamba_scan_fused_common.cuh).
// So gh0 agrees with it bit for bit, and so do gdt and gx, whose sums over
// n run in the plain version's order; the sums over d and t run in
// another.
//
// C interface (ctypes): every launch function returns cudaGetLastError().

#include "mamba_scan_fused_common.cuh"

namespace {

using namespace scan_fused;

constexpr int kThreads = 128;
constexpr int kStatesPerThread = 4;  // states of one channel a thread holds
constexpr int kSteps = 64;           // steps of a staged tile
constexpr int kStages = 2;           // tiles in shared memory: one in use, one landing
constexpr int kChunk = 8;            // steps between stored states, held in registers
constexpr int kSumThreads = 256;
static_assert(kSteps % kChunk == 0, "a tile is whole chunks");

// sum_{i < n} p[i * stride] in float64 for n a multiple of 8: 8
// interleaved runs, added pairwise
__device__ __forceinline__ double sum8(const float* p, int n, int stride) {
  double s[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) s[r] = p[r * stride];
  for (int i = 8; i < n; i += 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] += p[(i + r) * stride];
  }
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// One stage: gy [kSteps][CH] float32, then dt and x [kSteps][CH], then B
// and C [kSteps][N] in T.  Pass 1 stages dt, x and B only.
template <typename T>
struct Stage {
  float* gy;
  T *dt, *x, *B, *C;
  __device__ Stage(unsigned char* base, int CH, int N) {
    gy = reinterpret_cast<float*>(base);
    dt = reinterpret_cast<T*>(gy + kSteps * CH);
    x = dt + kSteps * CH;
    B = x + kSteps * CH;
    C = B + kSteps * N;
  }
  static __host__ __device__ size_t bytes(int CH, int N) {
    return (size_t)kSteps * CH * sizeof(float) + (size_t)kSteps * (2 * CH + 2 * N) * sizeof(T);
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
mamba_scan_fused_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                            const T* __restrict__ Bm, const T* __restrict__ Cm,
                            const float* __restrict__ A, const float* __restrict__ h0,
                            const float* __restrict__ gy, const float* __restrict__ gh_fin,
                            T* __restrict__ gdt, T* __restrict__ gx, float* __restrict__ gh0,
                            float* __restrict__ bounds, double* __restrict__ part,
                            double* __restrict__ a_part, int S, int di, int N, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = N / P;          // lanes of one channel
  const int CH = kThreads / L;  // channels of the CTA
  const size_t stage_bytes = Stage<T>::bytes(CH, N);
  // each thread's terms of gB or gC for the chunk's steps, [kChunk][CH][N]
  float* const red = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  const int cl = threadIdx.x / L, sub = threadIdx.x % L;  // channel; states sub + L j
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + cl;
  // A lane past di still runs both passes (its lanes' shuffles and the
  // barriers need it) on the zeros staged for it, adds 0 to every sum and
  // stores nothing.  L divides 32: the lanes of a channel are all live or
  // all dead.
  const bool live = d < di;
  const int64_t plane = (int64_t)di * N;  // state elements of one (b, t)
  // h0, gh_fin, gh0 and a_part of state j at hrow + L j; the stored states
  // of a thread are its own, at bp + j
  const int64_t hrow = (int64_t)bi * plane + (int64_t)d * N + sub;
  const int nk = (S + kSteps - 1) / kSteps;  // tiles
  const int nc = (S + kChunk - 1) / kChunk;  // chunks
  float* const bp = bounds + (int64_t)bi * nc * plane + (int64_t)d * N + sub * P;
  float ac[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ac[j] = live ? A[(int64_t)d * N + sub + L * j] : 0.f;

  // ---- pass 1: the state entering every chunk
  {
    float h[P];
#pragma unroll
    for (int j = 0; j < P; ++j) h[j] = live && h0 != nullptr ? h0[hrow + L * j] : 0.f;
    auto stage1 = [&](int k) {
      Stage<T> st(smem + (k % kStages) * stage_bytes, CH, N);
      const int t0 = k * kSteps;
      stage_rows<kSteps, kThreads>(st.dt, dt, bi, t0, S, di, d0, CH, vec);
      stage_rows<kSteps, kThreads>(st.x, x, bi, t0, S, di, d0, CH, vec);
      stage_states<kSteps, kThreads>(st.B, Bm, bi, t0, S, N, vec);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) stage1(s);
      cp_async_commit();
    }
    for (int k = 0; k < nk; ++k) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (k + kStages - 1 < nk) stage1(k + kStages - 1);
      cp_async_commit();
      const Stage<T> st(smem + (k % kStages) * stage_bytes, CH, N);
      const int t0 = k * kSteps;
      const int steps = min(kSteps, S - t0);
      for (int u = 0; u < steps; ++u) {
        if (u % kChunk == 0 && live) {
#pragma unroll
          for (int j = 0; j < P; ++j) bp[(int64_t)((t0 + u) / kChunk) * plane + j] = h[j];
        }
        const float dtv = to_f(st.dt[u * CH + cl]);
        const float dx = term_dx(dtv, to_f(st.x[u * CH + cl]));
        float bv[P];
        load_p<T, P>(st.B + u * N + sub, L, bv);
        advance(h, ac, dtv, dx, bv);
      }
    }
  }

  // ---- pass 2: tiles, and the chunks of each, from last to first
  float g[P], a_next[P];
  double ga_sum[P];  // gA's terms of the chunks done
#pragma unroll
  for (int j = 0; j < P; ++j) {
    g[j] = live && gh_fin != nullptr ? gh_fin[hrow + L * j] : 0.f;
    a_next[j] = 1.f;  // at t = S-1 the carry is gh_fin itself
    ga_sum[j] = 0.0;
  }
  auto stage2 = [&](int k) {
    Stage<T> st(smem + (k % kStages) * stage_bytes, CH, N);
    const int t0 = k * kSteps;
    stage_rows<kSteps, kThreads>(st.gy, gy, bi, t0, S, di, d0, CH, vec);
    stage_rows<kSteps, kThreads>(st.dt, dt, bi, t0, S, di, d0, CH, vec);
    stage_rows<kSteps, kThreads>(st.x, x, bi, t0, S, di, d0, CH, vec);
    stage_states<kSteps, kThreads>(st.B, Bm, bi, t0, S, N, vec);
    stage_states<kSteps, kThreads>(st.C, Cm, bi, t0, S, N, vec);
  };
  __syncthreads();  // pass 1's last tile is read: its stage may be refilled
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (nk - 1 - s >= 0) stage2(nk - 1 - s);
    cp_async_commit();
  }
  double* const pp = part + ((int64_t)bi * gridDim.x + blockIdx.x) * S * 2 * N;
  const int64_t row0 = (int64_t)bi * S * di + d;  // gdt, gx at row0 + t * di
  // the CTA's sum over its channels of red[u][.][m] for the chunk's steps,
  // into the partials' column `col` (0: gB, N: gC)
  auto reduce_chunk = [&](int t_first, int col) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int u = i / N, m = i - u * N;
      if (t_first + u < S) {
        pp[(int64_t)(t_first + u) * 2 * N + col + m] = sum8(red + u * CH * N + m, CH, N);
      }
    }
    __syncthreads();  // red is rewritten next
  };
  for (int k = nk - 1; k >= 0; --k) {  // tiles, last to first
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k - (kStages - 1) >= 0) stage2(k - (kStages - 1));
    cp_async_commit();
    const Stage<T> st(smem + (k % kStages) * stage_bytes, CH, N);
    const int t0 = k * kSteps;
    const int chunks = (min(kSteps, S - t0) + kChunk - 1) / kChunk;
    for (int c = chunks - 1; c >= 0; --c) {  // chunks, last to first
      const int u0 = c * kChunk;
      const int tc = t0 + u0;
      float h_in[P];
#pragma unroll
      for (int j = 0; j < P; ++j) h_in[j] = live ? bp[(int64_t)(tc / kChunk) * plane + j] : 0.f;
      // a and h through the chunk: av[u], hv[u] at step tc + u; gC's terms
      float av[kChunk][P], hv[kChunk][P];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const bool in = tc + u < S;
        const int s = u0 + u;
        const float dtv = in ? to_f(st.dt[s * CH + cl]) : 0.f;
        const float dx = in ? term_dx(dtv, to_f(st.x[s * CH + cl])) : 0.f;
        const float gyv = in ? st.gy[s * CH + cl] : 0.f;
        float bv[P];
        load_p<T, P>(st.B + (in ? s : 0) * N + sub, L, bv);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float hp = u > 0 ? hv[u - 1][j] : h_in[j];
          av[u][j] = in ? term_a(dtv, ac[j]) : 1.f;
          hv[u][j] = in ? update(av[u][j], hp, dx, bv[j]) : hp;
          red[(u * CH + cl) * N + sub + L * j] = __fmul_rn(hv[u][j], gyv);  // gC's term
        }
      }
      reduce_chunk(tc, N);
      // g from the chunk's last step to its first; gB's terms
      float ga_chunk[P];  // gA's terms of this chunk
#pragma unroll
      for (int j = 0; j < P; ++j) ga_chunk[j] = 0.f;
#pragma unroll
      for (int u = kChunk - 1; u >= 0; --u) {
        const bool in = tc + u < S;
        const int s = u0 + u;
        const float dtv = in ? to_f(st.dt[s * CH + cl]) : 0.f;
        const float xv = in ? to_f(st.x[s * CH + cl]) : 0.f;
        const float dx = term_dx(dtv, xv);
        const float gyv = in ? st.gy[s * CH + cl] : 0.f;
        float bv[P], cv[P];
        load_p<T, P>(st.B + (in ? s : 0) * N + sub, L, bv);
        load_p<T, P>(st.C + (in ? s : 0) * N + sub, L, cv);
        float gaaA[P], gbB[P];  // the terms of sum_n ga a A and of sum_n gb B
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float term = 0.f;
          gaaA[j] = gbB[j] = 0.f;
          if (in) {
            g[j] = __fadd_rn(__fmul_rn(gyv, cv[j]), __fmul_rn(a_next[j], g[j]));
            a_next[j] = av[u][j];
            const float gaa = __fmul_rn(__fmul_rn(g[j], u > 0 ? hv[u - 1][j] : h_in[j]),
                                        av[u][j]);  // ga a
            gaaA[j] = __fmul_rn(gaa, ac[j]);
            gbB[j] = __fmul_rn(g[j], bv[j]);
            ga_chunk[j] = __fadd_rn(ga_chunk[j], __fmul_rn(gaa, dtv));
            term = __fmul_rn(g[j], dx);
          }
          red[(u * CH + cl) * N + sub + L * j] = term;  // gB's term
        }
        float gdt_n = tree(gaaA), gx_n = tree(gbB);  // this thread's share of the sums
        for (int off = L >> 1; off > 0; off >>= 1) {
          gdt_n += __shfl_xor_sync(0xffffffffu, gdt_n, off);
          gx_n += __shfl_xor_sync(0xffffffffu, gx_n, off);
        }
        if (in && live && sub == 0) {
          gdt[row0 + (int64_t)(tc + u) * di] = from_f<T>(__fadd_rn(gdt_n, __fmul_rn(gx_n, xv)));
          gx[row0 + (int64_t)(tc + u) * di] = from_f<T>(__fmul_rn(gx_n, dtv));
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) ga_sum[j] += (double)ga_chunk[j];
      reduce_chunk(tc, 0);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      gh0[hrow + L * j] = __fmul_rn(a_next[j], g[j]);  // a_0 g_0
      a_part[hrow + L * j] = ga_sum[j];
    }
  }
}

// gB, gC [b, t, n]: the CTAs' partials summed in CTA order; gA [d, n]: the
// batch rows' partials summed in row order; in float64, rounded once.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_fused_bwd_sum(const double* __restrict__ part, const double* __restrict__ a_part,
                         T* __restrict__ gB, T* __restrict__ gC, float* __restrict__ gA, int B,
                         int S, int N, int ctas, int di) {
  const int64_t i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  const int64_t SN = (int64_t)S * N, nbc = B * SN, plane = (int64_t)di * N;
  if (i < nbc) {
    const int64_t bi = i / SN, r = i - bi * SN;  // r = t N + n
    const int64_t t = r / N, m = r - t * N;
    const int64_t stride = 2 * SN;  // one CTA's partials
    const double* p = part + bi * ctas * stride + t * 2 * N + m;
    double sb = 0.0, sc = 0.0;
    for (int j = 0; j < ctas; ++j) sb += p[j * stride];  // gB's partials
    for (int j = 0; j < ctas; ++j) sc += p[j * stride + N];  // gC's
    gB[i] = from_f<T>((float)sb);
    gC[i] = from_f<T>((float)sc);
  } else if (i < nbc + plane) {
    const int64_t k = i - nbc;
    double s = 0.0;
    for (int b = 0; b < B; ++b) s += a_part[b * plane + k];  // gA's partials in row order
    gA[k] = (float)s;
  }
}

int64_t channels_of(int N) {
  const int P = N < kStatesPerThread ? N : kStatesPerThread;
  return kThreads / (N / P);
}
int64_t ctas_of(int di, int N) { return (di + channels_of(N) - 1) / channels_of(N); }
int64_t bounds_floats(int B, int S, int di, int N) {
  return (int64_t)B * ((S + kChunk - 1) / kChunk) * di * N;
}
int64_t part_doubles(int B, int S, int di, int N) {
  return (int64_t)B * ctas_of(di, N) * S * 2 * N;
}

template <typename T, int P>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
           const float* h0, const float* gy, const float* gh_fin, void* gdt, void* gx,
           void* gB, void* gC, float* gA, float* gh0, float* work, int B, int S, int di, int N,
           bool vec, cudaStream_t stream) {
  const int CH = kThreads / (N / P);
  const int64_t ctas = ctas_of(di, N);
  if (ctas > 2147483647LL || B > 65535) return (int)cudaErrorInvalidValue;
  double* a_part = reinterpret_cast<double*>(work);  // first: 8-byte aligned
  double* part = a_part + (int64_t)B * di * N;
  float* bounds = reinterpret_cast<float*>(part + part_doubles(B, S, di, N));
  const size_t bytes = kStages * Stage<T>::bytes(CH, N) + (size_t)kChunk * kThreads * P * 4;
  auto kernel = mamba_scan_fused_bwd_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)ctas, (unsigned)B), kThreads, bytes, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, gy, gh_fin, static_cast<T*>(gdt), static_cast<T*>(gx),
      gh0, bounds, part, a_part, S, di, N, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * S * N + (int64_t)di * N;
  const int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  mamba_scan_fused_bwd_sum<T><<<(unsigned)blocks, kSumThreads, 0, stream>>>(
      part, a_part, static_cast<T*>(gB), static_cast<T*>(gC), gA, B, S, N, (int)ctas, di);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* Bm, const void* Cm, const float* A,
             const float* h0, const float* gy, const float* gh_fin, void* gdt, void* gx,
             void* gB, void* gC, float* gA, float* gh0, float* work, int B, int S, int di,
             int N, cudaStream_t stream) {
  const bool vec = aligned16(dt) && aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(gy) && (int64_t)di * sizeof(T) % 16 == 0 &&
                   (int64_t)di * sizeof(float) % 16 == 0 &&
                   (int64_t)S * N * sizeof(T) % 16 == 0;
#define FUSED_BWD_CASE(PP)                                                               \
  case PP:                                                                               \
    return launch<T, PP>(dt, x, Bm, Cm, A, h0, gy, gh_fin, gdt, gx, gB, gC, gA, gh0, work, \
                         B, S, di, N, vec, stream);
  switch (N < kStatesPerThread ? N : kStatesPerThread) {
    FUSED_BWD_CASE(1)
    FUSED_BWD_CASE(2)
    FUSED_BWD_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FUSED_BWD_CASE
}

}  // namespace

// Bytes of the workspace a call needs: the batch rows' partials of gA [B,
// di, N] and the CTAs' partials of gB and gC [B, CTAs, S, 2 N] float64, and
// the states entering every chunk [B, ceil(S / kChunk), di, N] float32.
extern "C" long long mamba_scan_fused_bwd_workspace_bytes(int B, int S, int di, int N) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > 32 || 32 % N) return -1;
  return (long long)(bounds_floats(B, S, di, N) + 2 * part_doubles(B, S, di, N) + 2 *
                     (int64_t)B * di * N) * 4;
}

// dt, x [B, S, di], B, C [B, S, N] all float32 (dtype 0) or all bfloat16
// (dtype 1); A [di, N], h0 [B, di, N] or NULL, gy [B, S, di], gh_fin [B,
// di, N] or NULL float32; gdt, gx [B, S, di] and gB, gC [B, S, N] in the
// inputs' dtype; gA [di, N], gh0 [B, di, N] float32; work of
// mamba_scan_fused_bwd_workspace_bytes; all contiguous.  N must divide 32.
extern "C" int mamba_scan_fused_bwd_launch(const void* dt, const void* x, const void* Bm,
                                           const void* Cm, const void* A, const void* h0,
                                           const void* gy, const void* gh_fin, void* gdt,
                                           void* gx, void* gB, void* gC, void* gA, void* gh0,
                                           void* work, int B, int S, int di, int N, int dtype,
                                           void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > 32 || 32 % N) {
    return (int)cudaErrorInvalidValue;
  }
  const float* fA = static_cast<const float*>(A);
  const float* fh0 = static_cast<const float*>(h0);
  const float* fgy = static_cast<const float*>(gy);
  const float* fgh = static_cast<const float*>(gh_fin);
  float* fgA = static_cast<float*>(gA);
  float* fgh0 = static_cast<float*>(gh0);
  float* fw = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(dt, x, Bm, Cm, fA, fh0, fgy, fgh, gdt, gx, gB, gC, fgA, fgh0,
                                   fw, B, S, di, N, s);
    case 1: return dispatch<__nv_bfloat16>(dt, x, Bm, Cm, fA, fh0, fgy, fgh, gdt, gx, gB, gC, fgA,
                                           fgh0, fw, B, S, di, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba_scan_fused_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
