// Backward of the selective scan (Mamba-1 recurrence) for Hopper (sm_90a),
// float32.  Forward (csrc/mamba_scan.cu):
//   h_t = a_t * h_{t-1} + b_t,   y_t[d] = sum_n h_t[d, n] * c_t[n],
// from h_{-1} = h0.  Given the cotangents gy [B, S, di] of y and gh_fin
// [B, di, N] of h_last (NULL: zeros), this computes
//   g_t  = gy_t c_t + a_{t+1} g_{t+1}     from t = S-1 (a_S g_S := gh_fin)
//   ga_t = g_t h_{t-1},  gb_t = g_t,  gc_t[n] = sum_d h_t[d, n] gy_t[d],
//   gh0  = a_0 g_0.
//
// Replaces `_scan_bwd`, the backward of the custom VJP `selective_scan` in
// src/repro/models/mamba.py.  There it is plain XLA: the states h_t are
// recomputed by the chunked associative scan and kept whole ([B, S, di, N]),
// and g is an associative scan run in reverse.  Here, as in the forward,
// each thread owns one state element (b, d, n) and walks the sequence in a
// loop; the N threads of one channel sit in consecutive lanes of one warp.
// Walking backward needs h_{t-1} at every step, which the forward did not
// keep, so the thread walks the sequence twice:
//
//   pass 1, t forward: stores the state entering every chunk of kChunk
//     steps (a float32 scratch [B, ceil(S / kChunk), di, N], 1/kChunk of a);
//   pass 2, chunks from last to first: loads the chunk's a_t, b_t, gy_t and
//     c_t into registers, recomputes h inside the chunk from the state
//     entering it, then runs g backward over the chunk, carrying g and the
//     chunk's first a into the chunk before it.  ga and gb are written once.
//
// gc sums over the channels, across threads and CTAs.  Each CTA reduces its
// channels for every (t, n): shuffles over the lanes of one n inside a warp,
// then the warps in order through shared memory, and writes one partial to
// a workspace [B, CTAs of a batch row, S, N].  A second launch sums the
// partials of each (b, t, n) in CTA order.  No atomics: every sum runs in a
// fixed order, so two calls give the same bits.
//
// Bound on the H100: bytes.  The least traffic reads a, b, gy (and c, h0,
// gh_fin) once and writes ga, gb (and gc, gh0) once; at Falcon-Mamba's
// training microbatch [1, 2048, 8192, 16] that is 4.36 GB, 1.302 ms at
// 3.35 TB/s.  The two passes read a and b twice, ~6.7 GB with the
// boundary states and the gc partials.  A thread's loop carries its state
// through all S steps, so each CTA runs as long as the whole call; no CTA
// waits on another (the gc partials are summed by a second launch), so any
// grid size is correct, and a grid in one wave is a choice for speed: at
// Falcon's microbatch it is 512 CTAs of 256 threads, and __launch_bounds__
// caps a thread at 64 registers so that 4 CTAs fit on each of the 132 SMs.
// kChunk = 8 steps of four arrays in registers is what that cap holds; the
// chunk's 32 loads are all issued before the first is used, which keeps
// ~17 MB in flight across the card.
//
// Every update rounds as the plain version (kernels/ref.py,
// mamba_scan_bwd_ref) does: a multiply, then an add, no fused multiply-add.
// So h, g, ga, gb and gh0 agree with it bit for bit; only gc's sum over
// the channels runs in another order.
//
// C interface (ctypes): every launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // 64 registers a thread
constexpr int kChunk = 8;      // steps between stored states, held in registers
constexpr int kSumThreads = 256;

__host__ __device__ constexpr int chunks(int S) { return (S + kChunk - 1) / kChunk; }

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ c, const float* __restrict__ h0,
                      const float* __restrict__ gy, const float* __restrict__ gh_fin,
                      float* __restrict__ ga, float* __restrict__ gb, float* __restrict__ gh0,
                      float* __restrict__ part, float* __restrict__ bounds, int S, int di) {
  constexpr int kChannels = kThreads / N;  // channels a CTA
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][kChunk][N];  // each warp's share of gc, by step and n

  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * kChannels + threadIdx.x / N;
  // A lane past di still takes part in the shuffles and barriers; it reads
  // a and b of channel 0 of its batch row, adds 0 to gc and writes nothing
  // (nor reads the boundary states, which other CTAs may still be writing).
  // N divides 32, so the N lanes of a channel are all live or all dead.
  const bool live = d < di;
  const int64_t plane = (int64_t)di * N;  // state elements of one (b, t)
  const int64_t dn = live ? (int64_t)d * N + n : n;
  const int64_t at = (int64_t)bi * S * plane + dn;  // a, b, ga, gb at t: at + t * plane
  const int nc = chunks(S);
  float* const bp = bounds + (int64_t)bi * nc * plane + dn;
  const float* const gyp = gy + (int64_t)bi * S * di + (live ? d : 0);
  const float* const cp = c + (int64_t)bi * S * N + n;
  float* const pp = part + ((int64_t)bi * gridDim.x + blockIdx.x) * S * N;

  // ---- pass 1: the state entering every chunk (the last chunk's end is not needed)
  float h = h0 != nullptr ? h0[(int64_t)bi * plane + dn] : 0.f;
  for (int k = 0;; ++k) {
    if (live) bp[k * plane] = h;
    if (k == nc - 1) break;
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {  // every chunk before the last is whole
      const int64_t t = (int64_t)k * kChunk + u;
      av[u] = a[at + t * plane];
      bv[u] = b[at + t * plane];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
  }

  // ---- pass 2: chunks from last to first
  float g = gh_fin != nullptr ? gh_fin[(int64_t)bi * plane + dn] : 0.f;
  float a_next = 1.f;  // at t = S-1 the carry is gh_fin itself
  for (int k = nc - 1; k >= 0; --k) {  // chunks, last to first
    const int t0 = k * kChunk;
    float av[kChunk], hv[kChunk], gv[kChunk], cv[kChunk];
    const float h_in = live ? bp[k * plane] : 0.f;  // h_{t0 - 1}
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      const bool in = t < S;
      av[u] = in ? a[at + (int64_t)t * plane] : 1.f;
      hv[u] = in ? b[at + (int64_t)t * plane] : 0.f;
      gv[u] = in && live ? gyp[(int64_t)t * di] : 0.f;
      cv[u] = in ? cp[(int64_t)t * N] : 0.f;
    }
    // h through the chunk: hv[u] becomes h_{t0 + u}
    float hh = h_in;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      hh = __fadd_rn(__fmul_rn(av[u], hh), hv[u]);
      hv[u] = hh;
    }
    // gc's share of this warp: sum over the lanes of one n
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      float p = live ? __fmul_rn(hv[u], gv[u]) : 0.f;
#pragma unroll
      for (int off = N; off < 32; off <<= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane < N) red[warp][u][lane] = p;
    }
    // g from the chunk's last step to its first
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const int t = t0 + u;
      if (t < S) {
        g = __fadd_rn(__fmul_rn(gv[u], cv[u]), __fmul_rn(a_next, g));
        a_next = av[u];
        if (live) {
          ga[at + (int64_t)t * plane] = __fmul_rn(g, u > 0 ? hv[u - 1] : h_in);
          gb[at + (int64_t)t * plane] = g;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {  // the warps in order
      const int u = i / N, m = i % N;
      if (t0 + u < S) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][u][m];
        pp[(int64_t)(t0 + u) * N + m] = s;
      }
    }
    __syncthreads();  // red is rewritten by the next chunk
  }
  if (live) gh0[(int64_t)bi * plane + dn] = __fmul_rn(a_next, g);  // a_0 g_0
}

// gc[b, t, n] = the CTAs' partials of (b, t, n) summed in CTA order.
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_bwd_gc_sum(const float* __restrict__ part, float* __restrict__ gc, int ctas,
                      int64_t SN, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t bi = i / SN;
  const float* p = part + bi * ctas * SN + (i - bi * SN);
  float s = 0.f;
#pragma unroll 8
  for (int j = 0; j < ctas; ++j) s += p[j * SN];  // the partials in CTA order
  gc[i] = s;
}

int64_t ctas_of(int di, int N) { return (di + kThreads / N - 1) / (kThreads / N); }
int64_t part_floats(int B, int S, int di, int N) { return (int64_t)B * ctas_of(di, N) * S * N; }

template <int N>
int launch(const float* a, const float* b, const float* c, const float* h0, const float* gy,
           const float* gh_fin, float* ga, float* gb, float* gc, float* gh0, float* work,
           int B, int S, int di, cudaStream_t stream) {
  const int64_t ctas = ctas_of(di, N);
  if (ctas > 2147483647LL || B > 65535) return (int)cudaErrorInvalidValue;
  float* part = work;
  float* bounds = work + part_floats(B, S, di, N);
  mamba_scan_bwd_kernel<N><<<dim3((unsigned)ctas, (unsigned)B), kThreads, 0, stream>>>(
      a, b, c, h0, gy, gh_fin, ga, gb, gh0, part, bounds, S, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * S * N;
  const int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  mamba_scan_bwd_gc_sum<<<(unsigned)blocks, kSumThreads, 0, stream>>>(
      part, gc, (int)ctas, (int64_t)S * N, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the workspace a call needs: the gc partials [B, CTAs, S, N] and
// the boundary states [B, ceil(S / kChunk), di, N], float32.
extern "C" long long mamba_scan_bwd_workspace_bytes(int B, int S, int di, int N) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || 32 % N) return -1;
  return (long long)(part_floats(B, S, di, N) + (int64_t)B * chunks(S) * di * N) * 4;
}

// a, b [B, S, di, N]; c [B, S, N]; h0 [B, di, N] or NULL; gy [B, S, di];
// gh_fin [B, di, N] or NULL; ga, gb [B, S, di, N]; gc [B, S, N]; gh0
// [B, di, N]; work of mamba_scan_bwd_workspace_bytes; all contiguous
// float32.  N must divide 32.
extern "C" int mamba_scan_bwd_launch(const void* a, const void* b, const void* c,
                                     const void* h0, const void* gy, const void* gh_fin,
                                     void* ga, void* gb, void* gc, void* gh0, void* work,
                                     int B, int S, int di, int N, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fc = static_cast<const float*>(c);
  const float* fh0 = static_cast<const float*>(h0);
  const float* fgy = static_cast<const float*>(gy);
  const float* fgh = static_cast<const float*>(gh_fin);
  float* fga = static_cast<float*>(ga);
  float* fgb = static_cast<float*>(gb);
  float* fgc = static_cast<float*>(gc);
  float* fgh0 = static_cast<float*>(gh0);
  float* fw = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA_SCAN_BWD_CASE(NN) \
  case NN: return launch<NN>(fa, fb, fc, fh0, fgy, fgh, fga, fgb, fgc, fgh0, fw, B, S, di, s);
  switch (N) {
    MAMBA_SCAN_BWD_CASE(1)
    MAMBA_SCAN_BWD_CASE(2)
    MAMBA_SCAN_BWD_CASE(4)
    MAMBA_SCAN_BWD_CASE(8)
    MAMBA_SCAN_BWD_CASE(16)
    MAMBA_SCAN_BWD_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_SCAN_BWD_CASE
}

extern "C" const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
