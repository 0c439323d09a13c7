// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an online softmax, bf16 in and out, fp32 state.
//
// Replaces the TPU kernel `flash_attention_kernel` / `flash_attention_pallas`
// of src/repro/kernels/flash_attention.py.  On the TPU the KV-block grid
// dimension runs in order on one core and the softmax state (m, l, acc)
// lives in VMEM scratch across grid steps.  Here CTAs run in parallel and in
// no order, so one CTA owns one (batch*head, 64-row q tile) and walks the KV
// tiles in a loop of its own, keeping m and l in registers and acc in shared
// memory.  GQA maps q-head row `bh` to kv row `bh / group`, as the Pallas
// index maps do.  KV tiles past the causal frontier or before the window are
// never visited (the Pallas kernel's `needed` test).  Unlike the Pallas
// kernel, the ragged edge is masked: Sq and Skv need not be multiples of 64
// (a served prompt rarely is).
//
// Bound on the H100: per q-head a causal pass does ~2*S*S*hd flops and
// moves ~4*S*hd bytes (q in, o out, bf16; K/V are shared by the group), so
// ~S/2 flop/byte.  At the Yi prefill shape (S = 512) that is just under the
// ~295 flop/byte ridge: bytes bind, barely; longer prompts are bound by the
// tensor cores.  This first version takes the simple route to both: Q K^T
// and P V run on the tensor cores as bf16 16x16x16 WMMA fragments with fp32
// accumulation, K/V tiles are staged once per CTA in shared memory with
// 16-byte loads, and the softmax is scalar fp32.  It does not overlap loads
// with math (no cp.async/TMA, no wgmma, no warp
// specialisation); that is later work.
//
// Layout: q [BH, Sq, HD], k/v [BH/group, Skv, HD], o [BH, Sq, HD], all
// contiguous bf16.  C interface (ctypes): returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float kNeg = -1e30f;  // masked score, as in the reference

template <int HD>
struct Smem {
  static constexpr int LDH = HD + 8;   // bf16 Q/K/V tiles (pad against bank conflicts)
  static constexpr int LDS = BK + 4;   // fp32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = HD + 4;   // fp32 output accumulator
  // every region size is a multiple of 128 bytes, so each region start is
  // aligned as WMMA requires (32 bytes)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * BQ * LDO;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv,
                 int group, int causal, int window, float scale) {
  using L = Smem<HD>;
  constexpr int LDH = L::LDH, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  constexpr int VPR = HD / 8;  // 16-byte vectors per row

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + (size_t)bh * Sq * HD;
  const bf16* kb = k + (size_t)(bh / group) * Skv * HD;
  const bf16* vb = v + (size_t)(bh / group) * Skv * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp * 16;  // this warp's first row in the tile
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = zero;
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * LDH + c) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;

  // per-row softmax state of this warp's 16 rows, replicated in every lane
  float m_row[16], l_row[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m_row[rr] = kNeg;
    l_row[rr] = 0.f;
  }

  // KV tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int nk = (Skv + BK - 1) / BK;
  const int kt_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int lo = q0 - window + 1;
  const int kt_lo = (window > 0 && lo > 0) ? lo / BK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * HD + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDH + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LDH + c) = vv;
    }
    __syncthreads();

    // S[16 x BK] = Q[16 x HD] K^T for this warp's rows
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + wr * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(b, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sacc, a, b, sacc);
      }
      wmma::store_matrix_sync(Ss + wr * LDS + n * 16, sacc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane owns columns lane and lane+32
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = wr + rr;
      const int qp = q0 + r;
      float sv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int kp = k0 + c;
        float s = Ss[r * LDS + c] * scale;
        if (kp >= Skv) {
          s = -INFINITY;  // ragged edge: past the end of the keys, never attended
        } else {
          bool ok = causal ? (kp <= qp) : true;
          if (window > 0) ok = ok && (kp > qp - window);
          if (!ok) s = kNeg;
        }
        sv[j] = s;
      }
      float mloc = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_new = fmaxf(m_row[rr], mloc);
      const float alpha = expf(m_row[rr] - m_new);
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      Ps[r * LDP + lane] = __float2bfloat16(p0);
      Ps[r * LDP + lane + 32] = __float2bfloat16(p1);
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_row[rr] = l_row[rr] * alpha + psum;
      m_row[rr] = m_new;
      for (int c = lane; c < HD; c += 32) Os[r * LDO + c] *= alpha;
    }
    __syncwarp();

    // O[16 x HD] += P[16 x BK] V[BK x HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + wr * LDO + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + wr * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, Vs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(oacc, a, b, oacc);
      }
      wmma::store_matrix_sync(Os + wr * LDO + n * 16, oacc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator is visible even if no tile ran

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qp = q0 + wr + rr;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_row[rr], 1e-30f);
    bf16* orow = o + ((size_t)bh * Sq + qp) * HD;
    for (int c = lane; c < HD; c += 32)
      orow[c] = __float2bfloat16(Os[(wr + rr) * LDO + c] / l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
           int group, int causal, int window, float scale, cudaStream_t stream) {
  const int bytes = (int)Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, group, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// window <= 0 means no sliding window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int Sq, int Skv, int head_dim, int group,
                                      int causal, int window, float scale, void* stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || group <= 0 || BH % group != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, o, BH, Sq, Skv, group, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, BH, Sq, Skv, group, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, BH, Sq, Skv, group, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
