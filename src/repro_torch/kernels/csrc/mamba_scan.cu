// Selective scan (Mamba-1 recurrence) for Hopper (sm_90a), float32:
//   h_t = a_t * h_{t-1} + b_t         elementwise over the state [B, di, N]
//   y_t[d] = sum_n h_t[d, n] * c_t[n]
// returning y [B, S, di] and h_last [B, di, N], from an optional h0.
//
// Replaces the TPU kernel `mamba_scan_kernel` / `mamba_scan_pallas` of
// src/repro/kernels/mamba_scan.py.  There the grid (batch, d_inner blocks,
// seq chunks) runs its last axis in order on one core and carries the state
// of a d_inner block in VMEM scratch from chunk to chunk.  Here blocks run
// in parallel and in no order, so the sequence is a loop inside one thread:
// each thread owns one state element (b, d, n), keeps h in a register and
// walks t = 0 .. S-1.  Nothing crosses threads but the readout: the N
// threads of one channel d sit in consecutive lanes of one warp (N divides
// 32), and their products h * c_t are summed by __shfl_xor_sync, after which
// one lane stores y[b, t, d].  Unlike the Pallas kernel it takes any S (no
// chunk divisibility) and an initial state h0 (NULL means zeros).
//
// Bound on the H100: bytes.  Every a and b value is read once and used for
// two flops (and c_t for two more), ~0.5 flop/byte against the ~20 flop/byte
// ridge of the fp32 CUDA cores.  a and b dominate: at the serving shape
// [4, 512, 8192, 16] they are 1.07 GB each.  Per time step a warp reads
// 128 contiguous bytes of a and of b (the (di, N) plane is contiguous), so
// every load is coalesced.  A thread whose loop loaded a_t and b_t and then
// waited for them would leave the card idle for a memory latency per step:
// the loop is unrolled by kUnroll steps, whose loads are all issued before
// the first of them is used, and every SM holds as many threads as it can,
// whose loads overlap each other's waits.  Both pull on the registers:
// kUnroll = 2 keeps the kernel at 32 registers (N >= 4), so 8 blocks of 256
// threads, the SM's 2048, fit on each SM.  At the serving shape on an H100
// that ran at 2.96 TB/s, 4 steps (40 registers) at 2.82 TB/s and 8 steps
// (48 registers, 5 blocks per SM) at 1.33 TB/s
// (experiments/torch_scan_unroll.py).
//
// The state update rounds as the plain version does (a multiply, then an
// add; no fused multiply-add), so h and h_last agree with it bit for bit;
// only the readout's sum over n runs in another order.
//
// C interface (ctypes): every function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_last, int64_t total,
                  int S, int di) {
  const int64_t plane = (int64_t)di * N;  // state elements per (b, t)
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // A lane past the end still takes part in the shuffles (every lane of a
  // warp must); it reads element 0 and writes nothing.  N divides 32 and
  // `total`, so the N lanes of a channel are all live or all dead.
  const bool live = e < total;
  const int64_t el = live ? e : 0;
  const int64_t bi = el / plane;
  const int64_t dn = el - bi * plane;  // d * N + n
  const int n = (int)(dn % N);
  const int64_t d = dn / N;

  const float* ap = a + bi * S * plane + dn;
  const float* bp = b + bi * S * plane + dn;
  const float* cp = c + bi * S * N + n;
  float* yp = y + bi * S * di + d;
  const bool writer = live && n == 0;

  float h = h0 != nullptr ? h0[el] : 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        av[u] = ap[(int64_t)t * plane];
        bv[u] = bp[(int64_t)t * plane];
        cv[u] = cp[(int64_t)t * N];
      } else {  // past the end: h stays as it is, nothing is stored
        av[u] = 1.f;
        bv[u] = 0.f;
        cv[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      float p = __fmul_rn(h, cv[u]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (writer && t0 + u < S) yp[(int64_t)(t0 + u) * di] = p;
    }
  }
  if (live) h_last[e] = h;
}

template <int N>
int launch(const float* a, const float* b, const float* c, const float* h0, float* y,
           float* h_last, int B, int S, int di, cudaStream_t stream) {
  const int64_t total = (int64_t)B * di * N;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  mamba_scan_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(a, b, c, h0, y, h_last,
                                                                   total, S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b [B, S, di, N]; c [B, S, N]; h0 [B, di, N] or NULL; y [B, S, di];
// h_last [B, di, N]; all contiguous float32.  N must divide 32.
extern "C" int mamba_scan_launch(const void* a, const void* b, const void* c, const void* h0,
                                 void* y, void* h_last, int B, int S, int di, int N,
                                 void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fc = static_cast<const float*>(c);
  const float* fh0 = static_cast<const float*>(h0);
  float* fy = static_cast<float*>(y);
  float* fh = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    case 2: return launch<2>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    case 4: return launch<4>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    case 8: return launch<8>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    case 16: return launch<16>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    case 32: return launch<32>(fa, fb, fc, fh0, fy, fh, B, S, di, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
