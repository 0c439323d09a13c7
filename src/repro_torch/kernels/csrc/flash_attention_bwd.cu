// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of causal
// and/or sliding-window GQA attention from the forward's output and its
// per-row logsumexp, bf16 in and out, fp32 accumulation.
//
// Computes what `_bwd` of src/repro/models/flash.py computes (the custom VJP
// of the training attention; the reference has no Pallas kernel for it,
// XLA compiles its chunked loops):
//
//   delta = rowsum(dO * O)
//   P     = exp(S * scale - lse)          under the causal / window mask
//   dV    = P^T dO                        summed over the G q heads of a kv head
//   dP    = dO V^T
//   dS    = P * (dP - delta) * scale
//   dQ    = dS K,  dK = dS^T Q            dK summed over the G heads too
//
// Bound on the H100: operations.  Per q head a causal pass does five
// products of ~S*S/2*hd multiply-adds (S and P recomputed, dV, dP, dQ, dK:
// the dK/dV kernel and the dQ kernel each recompute S and dP, so seven are
// run) against ~8*S*hd bytes, far above the ~295 flop/byte ridge at S = 2048.
// This first design is right and simple rather than fast (`wgmma` and TMA
// are later work): three launches, no atomics, so the result is
// deterministic from run to run.
//
// - a pre-pass writes delta [BH, S] fp32, a group of lanes per row;
// - the dK/dV kernel: one CTA per (kv row, 64-key tile), 4 warps of 16
//   keys.  It walks the G q heads of its kv row and, for each, the 64-row
//   q tiles inside the causal / window frontier, with the next (head, q
//   tile)'s Q, dO, lse and delta in flight by cp.async into a two-stage
//   ring.  dK and dV of its 16 keys stay in each warp's registers (fp32)
//   across all of them, so the sum over the group needs no atomics and no
//   second pass.  S^T = K Q^T and dP^T = V dO^T come out of mma.sync
//   m16n8k16 with keys as rows, so P^T and dS^T are already the A operands
//   of dV += P^T dO and dK += dS^T Q (packed pairwise to bf16, as the
//   forward packs P);
// - the dQ kernel: one CTA per (q row, 64-q tile), 4 warps of 16 q rows,
//   walks the K/V tiles inside the frontier (as the forward does) and keeps
//   dQ in registers; it recomputes S and dP.
//
// Registers are the constraint at hd 128: dK and dV take 64 fp32 registers
// each, so the A operands (K, V, or Q, dO) are read by ldmatrix from shared
// memory at every k-step rather than held, and the scores are taken 32
// columns at a time (16 registers each for S and dP, not 32).
//
// Shared rows are padded by 16 bytes (the 8 rows of an ldmatrix phase on
// distinct banks).  Rows past S are zero-filled and masked: a q row past S
// must not reach dK/dV (its lse and delta are zero-filled, not its
// statistics), a key past S must not reach dQ.
//
// Layout: q, o, dO, dQ [BH, S, HD]; k, v, dK, dV [BH/group, S, HD], all
// contiguous bf16; lse, delta [BH, S] fp32, lse in natural-log units (the
// forward's).  HD is 16 or 128.  C interface (ctypes): returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;             // warps per CTA, 16 rows each
constexpr int BM = 16 * kWarps;       // rows a CTA owns: keys (dK/dV) or q rows (dQ)
constexpr int BN = 64;                // rows of each tile it walks: q rows or keys
constexpr int NH = 32;                // columns of S taken at once (half a tile)
constexpr int NTHREADS = 32 * kWarps;
constexpr int STAGES = 2;             // depth of the ring
constexpr float kLog2e = 1.4426950408889634f;

static_assert(BM == 64 && BN == 64 && NTHREADS == 2 * BN, "lse/delta copy: one value a thread");

// the smem tiles of head dim HD: rows padded by 16 bytes
template <int HD>
struct Tiles {
  static_assert(HD % 16 == 0, "head dim must be a multiple of mma's k-step");
  static constexpr int LD = HD + 8;
  static constexpr int tile = sizeof(bf16) * 64 * LD;  // one [64, HD] tile
  // dK/dV: K, V, then STAGES x (Q, dO, lse[64], delta[64])
  static constexpr int kv_stage = 2 * tile + 2 * BN * (int)sizeof(float);
  static constexpr int kv_bytes = 2 * tile + STAGES * kv_stage;
  // dQ: Q, dO, then STAGES x (K, V)
  static constexpr int q_bytes = 2 * tile + STAGES * 2 * tile;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 64 rows of a [n, HD] matrix from row r0 into shared memory at dst, by
// cp.async; rows past n are zero-filled, their source clamped to a valid row
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int r0, int n,
                                          int tid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  constexpr int CHUNKS = 64 * VPR;
  static_assert(CHUNKS % NTHREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    const int gr = r0 + r;
    cp_async16(dst + (r * Tiles<HD>::LD + c) * (int)sizeof(bf16),
               src + (size_t)min(gr, n - 1) * HD + c, gr < n ? 16 : 0);
  }
}

// acc[16 x 8 NS] += A[16 x 16 KS] B: A's rows from shared memory at a (an
// ldmatrix lane address), B = M^T of the [8 NS, 16 KS] rows at b
template <int KS, int NS>
__device__ __forceinline__ void mma_abt(float (&acc)[NS][4], uint32_t a, uint32_t b, int ld) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + kk * 32);
#pragma unroll
    for (int p = 0; p < NS / 2; ++p) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (p * 16 * ld) * (int)sizeof(bf16) + kk * 32);
      mma16816(acc[2 * p], af, bf[0], bf[1]);
      mma16816(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x HD] += P[16 x NH] M[NH x HD]: P from score fragments (the
// accumulator layout of m16n8k16 is the A layout of the next product), M's
// rows from shared memory at b (an ldmatrix.trans lane address)
template <int HD>
__device__ __forceinline__ void mma_pm(float (&acc)[HD / 8][4], const float (&p)[NH / 8][4],
                                       uint32_t b) {
  constexpr int LD = Tiles<HD>::LD;
#pragma unroll
  for (int j = 0; j < NH / 16; ++j) {
    const uint32_t pa[4] = {
        pack_bf16x2(p[2 * j][0], p[2 * j][1]), pack_bf16x2(p[2 * j][2], p[2 * j][3]),
        pack_bf16x2(p[2 * j + 1][0], p[2 * j + 1][1]),
        pack_bf16x2(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int q = 0; q < HD / 16; ++q) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (j * 16 * LD + q * 16) * (int)sizeof(bf16));
      mma16816(acc[2 * q], pa, bf[0], bf[1]);
      mma16816(acc[2 * q + 1], pa, bf[2], bf[3]);
    }
  }
}

// each lane's ldmatrix row address in a tile of row stride LD, in bytes from
// the tile's start: A operand (16 rows from wr), B from [n, k] rows, B from
// [k, n] rows (.trans)
__device__ __forceinline__ uint32_t a_lane(int lane, int wr, int LD) {
  return ((wr + (lane & 15)) * LD + (lane >> 4) * 8) * sizeof(bf16);
}
__device__ __forceinline__ uint32_t b_lane(int lane, int LD) {
  return (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8) * sizeof(bf16);
}
__device__ __forceinline__ uint32_t t_lane(int lane, int LD) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) * sizeof(bf16);
}

// delta[row] = sum(dO[row] * O[row]) in fp32, a group of LPR lanes per row
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                float* __restrict__ delta, int rows) {
  constexpr int VPR = HD / 8;
  constexpr int LPR = VPR < 32 ? VPR : 32;
  constexpr int RPW = 32 / LPR;  // rows per warp
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * RPW + lane / LPR;
  float s = 0.f;
  if (row < rows) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * HD);
    const uint4* drow = reinterpret_cast<const uint4*>(dO + row * HD);
    for (int c = lane % LPR; c < VPR; c += LPR) {
      const uint4 a = orow[c], b = drow[c];
      const bf16* ah = reinterpret_cast<const bf16*>(&a);
      const bf16* bh = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __bfloat162float(ah[j]) * __bfloat162float(bh[j]);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && lane % LPR == 0) delta[row] = s;  // rowsum(dO * O)
}

// dK and dV of one (kv row, 64-key tile)
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int group, int causal,
               int window, float scale, float scale_log2) {
  using L = Tiles<HD>;
  constexpr int LD = L::LD;
  constexpr int NO = HD / 8;  // 16x8 blocks of a dK or dV row block
  constexpr int NS = NH / 8;  // 16x8 blocks of a half score tile

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_addr(smem), sv = sk + L::tile, ring = sv + L::tile;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BM;
  const bf16* kb = k + (size_t)bkv * S * HD;
  const bf16* vb = v + (size_t)bkv * S * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  // q tiles holding a row that some key of this tile is visible to: from
  // the diagonal (causal) to the last row within the window of the last key
  const int nq = (S + BN - 1) / BN;
  const int qt_lo = causal ? k0 / BN : 0;
  const int qt_hi = window > 0 ? min(nq, (k0 + BM - 2 + window) / BN + 1) : nq;
  const int nqt = qt_hi - qt_lo;
  const int n_it = group * nqt;  // every head of the group, every q tile

  // (head, q tile) of iteration it into its stage of the ring
  auto load_stage = [&](int it) {
    const int bh = bkv * group + it / nqt;
    const int q0 = (qt_lo + it % nqt) * BN;
    const uint32_t st = ring + (it % STAGES) * L::kv_stage;
    load_rows<HD>(st, q + (size_t)bh * S * HD, q0, S, tid);
    load_rows<HD>(st + L::tile, dO + (size_t)bh * S * HD, q0, S, tid);
    const int qp = q0 + (tid & (BN - 1));  // threads 0-63 copy lse, 64-127 delta
    const float* src = (tid < BN ? lse : delta) + (size_t)bh * S + min(qp, S - 1);
    cp_async4(st + 2 * L::tile + tid * (int)sizeof(float), src, qp < S ? 4 : 0);
  };

  if (n_it > 0) {
    load_rows<HD>(sk, kb, k0, S, tid);
    load_rows<HD>(sv, vb, k0, S, tid);
    load_stage(0);
  }
  cp_async_commit();

  const uint32_t la = a_lane(lane, wr, LD), lb = b_lane(lane, LD), lt = t_lane(lane, LD);
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;

  unsigned char* const ring_p = smem + 2 * L::tile;  // the ring, as a generic pointer
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // this iteration's stage has landed (and K, V at it = 0)
    __syncthreads();      // ... for every thread; every warp is done with it - 1's stage
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int q0 = (qt_lo + it % nqt) * BN;
    const uint32_t sq = ring + (it % STAGES) * L::kv_stage, sdo = sq + L::tile;
    const float* slse =
        reinterpret_cast<const float*>(ring_p + (it % STAGES) * L::kv_stage + 2 * L::tile);
    const float* sdel = slse + BN;
    // masks, only on a tile where one can bite: rows past S, the diagonal, the window's edge
    const bool edge = q0 + BN > S || (causal && q0 < k0 + BM) ||
                      (window > 0 && q0 + BN - 1 >= k0 + window);
#pragma unroll
    for (int hf = 0; hf < BN / NH; ++hf) {
      const int c0 = hf * NH;  // this half's first q row in the tile
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      mma_abt<HD / 16, NS>(s, sk + la, sq + lb + c0 * LD * (int)sizeof(bf16), LD);    // K Q^T
      mma_abt<HD / 16, NS>(dp, sv + la, sdo + lb + c0 * LD * (int)sizeof(bf16), LD);  // V dO^T
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + nb * 8 + 2 * t + (e & 1);  // q row in the tile
          float p = exp2f(s[nb][e] * scale_log2 - slse[c] * kLog2e);
          if (edge) {
            const int kp = k0 + wr + g + (e >> 1) * 8, qp = q0 + c;
            bool ok = qp < S;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) p = 0.f;
          }
          s[nb][e] = p;                                       // P^T
          dp[nb][e] = p * (dp[nb][e] - sdel[c]) * scale;      // dS^T
        }
      }
      mma_pm<HD>(dva, s, sdo + lt + c0 * LD * (int)sizeof(bf16));  // dV += P^T dO
      mma_pm<HD>(dka, dp, sq + lt + c0 * LD * (int)sizeof(bf16));  // dK += dS^T Q
    }
  }

  // dK, dV as bf16x2 straight from the fragments, keys past S left out
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + wr + g + 8 * i;
    if (kp >= S) continue;
    bf16* krow = dk + ((size_t)bkv * S + kp) * HD + 2 * t;
    bf16* vrow = dv + ((size_t)bkv * S + kp) * HD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NO; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(krow + nb * 8) =
          __floats2bfloat162_rn(dka[nb][2 * i], dka[nb][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nb * 8) =
          __floats2bfloat162_rn(dva[nb][2 * i], dva[nb][2 * i + 1]);
    }
  }
}

// dQ of one (q row, 64-row q tile)
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int S, int group, int causal, int window, float scale,
             float scale_log2) {
  using L = Tiles<HD>;
  constexpr int LD = L::LD;
  constexpr int NO = HD / 8;
  constexpr int NS = NH / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_addr(smem), sdo = sq + L::tile, ring = sdo + L::tile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const bf16* kb = k + (size_t)(bh / group) * S * HD;
  const bf16* vb = v + (size_t)(bh / group) * S * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int qw0 = q0 + wr;  // this warp's first row in the sequence
  const int qr = qw0 + g;   // this thread's rows: qr and qr + 8

  // KV tiles that can hold a visible key for some row of this q tile
  const int q_last = min(q0 + BM, S) - 1;
  const int nk = (S + BN - 1) / BN;
  const int kt_hi = causal ? min(nk, q_last / BN + 1) : nk;
  const int lo = q0 - window + 1;
  const int kt_lo = (window > 0 && lo > 0) ? lo / BN : 0;
  const int ntiles = kt_hi - kt_lo;

  // this thread's rows' lse (in log2 units) and delta; zeros past S
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr + 8 * i;
    lse2[i] = qp < S ? lse[(size_t)bh * S + qp] * kLog2e : 0.f;
    dl[i] = qp < S ? delta[(size_t)bh * S + qp] : 0.f;
  }

  auto load_stage = [&](int it) {
    const int kv0 = (kt_lo + it) * BN;
    const uint32_t st = ring + (it % STAGES) * 2 * L::tile;
    load_rows<HD>(st, kb, kv0, S, tid);
    load_rows<HD>(st + L::tile, vb, kv0, S, tid);
  };
  if (ntiles > 0) {
    load_rows<HD>(sq, q + (size_t)bh * S * HD, q0, S, tid);
    load_rows<HD>(sdo, dO + (size_t)bh * S * HD, q0, S, tid);
    load_stage(0);
  }
  cp_async_commit();

  const uint32_t la = a_lane(lane, wr, LD), lb = b_lane(lane, LD), lt = t_lane(lane, LD);
  float dqa[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) dqa[nb][0] = dqa[nb][1] = dqa[nb][2] = dqa[nb][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();  // this K/V stage has landed (and Q, dO at it = 0)
    __syncthreads();
    if (it + 1 < ntiles) load_stage(it + 1);
    cp_async_commit();

    const int kv0 = (kt_lo + it) * BN;
    const uint32_t sks = ring + (it % STAGES) * 2 * L::tile, svs = sks + L::tile;
    // masks where one can bite for some row of this warp: keys past S, the
    // causal diagonal, the window's edge
    const bool bites = kv0 + BN > S || (causal && kv0 + BN - 1 > qw0) ||
                       (window > 0 && kv0 <= qw0 + 15 - window);
#pragma unroll
    for (int hf = 0; hf < BN / NH; ++hf) {
      const int c0 = hf * NH;  // this half's first key in the tile
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      mma_abt<HD / 16, NS>(s, sq + la, sks + lb + c0 * LD * (int)sizeof(bf16), LD);    // Q K^T
      mma_abt<HD / 16, NS>(dp, sdo + la, svs + lb + c0 * LD * (int)sizeof(bf16), LD);  // dO V^T
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2f(s[nb][e] * scale_log2 - lse2[i]);
          if (bites) {
            const int kp = kv0 + c0 + nb * 8 + 2 * t + (e & 1), qp = qr + 8 * i;
            bool ok = kp < S;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) p = 0.f;
          }
          dp[nb][e] = p * (dp[nb][e] - dl[i]) * scale;  // dS
        }
      }
      mma_pm<HD>(dqa, dp, sks + lt + c0 * LD * (int)sizeof(bf16));  // dQ += dS K
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr + 8 * i;
    if (qp >= S) continue;
    bf16* row = dq + ((size_t)bh * S + qp) * HD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NO; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(row + nb * 8) =
          __floats2bfloat162_rn(dqa[nb][2 * i], dqa[nb][2 * i + 1]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const void* lse, void* dq, void* dk, void* dv, void* delta, int BH, int S, int group,
           int causal, int window, float scale, cudaStream_t st) {
  using L = Tiles<HD>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dO);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  constexpr int rows_per_cta = kWarps * (32 / (HD / 8 < 32 ? HD / 8 : 32));
  const int rows = BH * S;
  flash_bwd_delta<HD><<<(rows + rows_per_cta - 1) / rows_per_cta, NTHREADS, 0, st>>>(
      static_cast<const bf16*>(o), dop, dl, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kv_bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<HD><<<dim3(BH / group, (S + BM - 1) / BM), NTHREADS, L::kv_bytes, st>>>(
      qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, group, causal,
      window, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::q_bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<HD><<<dim3(BH, (S + BM - 1) / BM), NTHREADS, L::q_bytes, st>>>(
      qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dq), S, group, causal, window, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dO, dq [BH, S, head_dim]; k, v, dk, dv [BH / group, S, head_dim]; lse
// (the forward's) and delta (written here) [BH, S] fp32; window <= 0 means
// no sliding window.  head_dim 16 or 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta, int BH,
                                          int S, int head_dim, int group, int causal,
                                          int window, float scale, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || BH > 65535 ||
      (S + BM - 1) / BM > 65535 || (long long)BH * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 16)
    return launch<16>(q, k, v, o, dO, lse, dq, dk, dv, delta, BH, S, group, causal, window,
                      scale, s);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, dO, lse, dq, dk, dv, delta, BH, S, group, causal, window,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
