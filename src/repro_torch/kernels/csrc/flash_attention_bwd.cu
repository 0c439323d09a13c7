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
// No atomics anywhere, so the result has the same bits from run to run.
//
// - a pre-pass writes delta [BH, S] fp32, a group of lanes per row;
// - the dK/dV kernel: one CTA (one warpgroup) per (kv row, 64-key tile,
//   slice of kHeadsPerSlice q heads of the group), launched heaviest causal
//   key tile first, two CTAs an SM.  It walks its heads and, for each, the
//   64-row q tiles inside the causal / window frontier, with the next
//   (head, q tile)'s Q, dO, lse and delta in flight by cp.async into a
//   two-stage ring.  S^T = K Q^T and dP^T = V dO^T come out of wgmma
//   m64n64k16 with both operands in shared memory and keys as rows, so P^T
//   and dS^T, packed to bf16 in registers, are already the A operands of
//   dV += P^T dO and dK += dS^T Q (m64n{HD}k16, dO and Q read transposed
//   from shared memory).  The products go in commit groups so that P^T is
//   formed while dP^T's product runs, and dS^T while dV's.  dK and dV stay
//   in registers (fp32) across the slice, and the CTA writes them as fp32
//   partials to a workspace [2, slices, BH/G, S, HD];
// - a sum pass adds the partials in slice order 0, 1, ... into bf16 dK, dV;
// - the dQ kernel: one CTA (one warpgroup) per (q row, 64-row q tile),
//   heaviest first, walks the K/V tiles inside the frontier (as the forward
//   does) with the next in flight, recomputes S = Q K^T and dP = dO V^T (P
//   formed while dP's product runs) and keeps dQ += dS K in registers, all
//   three products on wgmma.
//
// Every tile sits in shared memory in the swizzled layout wgmma's
// descriptors read (see Sw), copied there by cp.async.  dK and dV take 128
// fp32 registers a thread at hd 128, S^T and dP^T 64 more: the dK/dV kernel
// is held to 255 registers (two CTAs an SM), which is why one warpgroup
// owns 64 keys and a q tile is 64 rows.
//
// Rows past S are zero-filled and masked: a q row past S must not reach
// dK/dV (its lse and delta are zero-filled, not its statistics), a key past
// S must not reach dQ.
//
// smem per CTA: dK/dV 100,352 B, dQ 99,328 B at hd 128
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

constexpr int kWarps = 4;             // warps per CTA (one warpgroup), 16 rows each
constexpr int BM = 16 * kWarps;       // rows a CTA owns: keys (dK/dV) or q rows (dQ)
constexpr int BN = 64;                // rows of each tile it walks: q rows or keys
constexpr int NTHREADS = 32 * kWarps;
constexpr int STAGES = 2;             // depth of the ring
constexpr int kHeadsPerSlice = 2;     // q heads of a group one dK/dV CTA walks
constexpr int kSumThreads = 256;      // threads of a CTA of the partials' sum, 4 elements each
constexpr float kLog2e = 1.4426950408889634f;

static_assert(BM == 64 && BN == 64 && NTHREADS == 2 * BN, "lse/delta copy: one value a thread");

// [64, HD] bf16 tiles in the layout wgmma's descriptors read: the
// columns in blocks of R bytes (128, or the whole row where it is
// narrower), each block 64 rows of R bytes, with the 16-byte chunks of a row
// permuted by the R-byte swizzle (address bits [4, 7) ^= bits [7, 10), as
// many of them as R has chunks); every tile 1024-byte aligned
template <int HD>
struct Sw {
  static constexpr int R = HD * 2 < 128 ? HD * 2 : 128;
  static_assert(R >= 32 && HD * 2 % R == 0, "a row is whole 32-, 64- or 128-byte blocks");
  static constexpr int block = 64 * R;                 // one column block
  static constexpr int tile = 64 * HD * (int)sizeof(bf16);
  static constexpr uint64_t mode = R == 128 ? 1 : R == 64 ? 2 : 3;  // the descriptor's swizzle
  // dK/dV: K, V, then STAGES x (Q, dO), then STAGES x (lse[64], delta[64]),
  // and 1024 bytes to align the base
  static constexpr int kv_bytes = (2 + 2 * STAGES) * tile + STAGES * 2 * BN * 4 + 1024;
  // dQ: Q, dO, then STAGES x (K, V), and the same 1024
  static constexpr int q_bytes = (2 + 2 * STAGES) * tile + 1024;
  // byte offset of 16-byte chunk c of row r
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t o = r * R + (c * 16) % R;
    return (c * 16 / R) * block + (o ^ (((o >> 7) & (R / 16 - 1)) << 4));
  }
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- wgmma ----

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets (in 16-byte units), swizzle mode
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | mode << 62;
}

// a K-major operand (the tile's rows are M or N, its columns K): k-step
// kk's 16 columns; 8-row groups R * 8 bytes apart
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Sw<HD>;
  return desc(tile + kk * 32 / T::R * T::block + kk * 32 % T::R, 16, 8 * T::R, T::mode);
}

// an MN-major operand (the tile's rows are K, its columns N): k-step kk's 16
// rows; column blocks (along N) a block apart, 8-row groups R * 8 bytes
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Sw<HD>;
  return desc(tile + kk * 16 * T::R, T::block, 8 * T::R, T::mode);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed group of products has landed, or all but the
// last (groups land in order)
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// the compiler may not move a use of d across this point (an accumulator
// is written by the asynchronous product until its wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// nor reuse a's registers before this point (an A operand is read by the
// asynchronous product until its wait)
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
// writes to shared memory by this thread (cp.async included) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] (+)= A B^T: A [64, 16] and B [64, 16] from shared memory by
// descriptor, both K-major (trans 0); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d[64 x 128] += A B: A from registers (each warp's 16 rows in the A layout
// of mma.sync m16n8k16), B from shared memory by descriptor, MN-major (trans 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "
      "%66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// the same at n 16
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  static_assert(HD == 16 || HD == 128, "an m64n{HD}k16 instruction for each head dim");
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n16(d, a, b);
}

// 64 rows of a [n, HD] matrix from row r0 into a swizzled tile at dst, by
// cp.async; rows past n are zero-filled, their source clamped to a valid row
template <int HD>
__device__ __forceinline__ void load_rows_sw(uint32_t dst, const bf16* src, int r0, int n,
                                             int tid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  constexpr int CHUNKS = 64 * VPR;
  static_assert(CHUNKS % NTHREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < CHUNKS / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    const int r = i / VPR, c = i % VPR;
    const int gr = r0 + r;
    cp_async16(dst + Sw<HD>::at(r, c), src + (size_t)min(gr, n - 1) * HD + c * 8,
               gr < n ? 16 : 0);
  }
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

// dK and dV of one (kv row, 64-key tile, slice of the group's heads)
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ part, int S, int group, int slices, int causal, int window,
               float scale, float scale_log2) {
  using T = Sw<HD>;
  constexpr int NO = HD / 2;  // accumulator floats of dK or dV a thread holds
  constexpr int NS = BN / 2;  // of a score tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t sk = smem_addr(smem), sv = sk + T::tile, ring = sv + T::tile;
  float* const stats = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * T::tile);

  const int bkv = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int h0 = slice * kHeadsPerSlice;                 // the slice's first head in the group
  const int nh = min(kHeadsPerSlice, group - h0);        // and its number of heads
  const int k0 = blockIdx.y * BM;  // heaviest causal key tiles first
  const bf16* kb = k + (size_t)bkv * S * HD;
  const bf16* vb = v + (size_t)bkv * S * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's 16 keys of the accumulators' 64 rows

  // q tiles holding a row that some key of this tile is visible to: from
  // the diagonal (causal) to the last row within the window of the last key
  const int nq = (S + BN - 1) / BN;
  const int qt_lo = causal ? k0 / BN : 0;
  const int qt_hi = window > 0 ? min(nq, (k0 + BM - 2 + window) / BN + 1) : nq;
  const int nqt = qt_hi - qt_lo;
  const int n_it = nh * nqt;  // every head of the slice, every q tile

  // (head, q tile) of iteration it into its stage of the ring
  auto load_stage = [&](int it) {
    const int bh = bkv * group + h0 + it / nqt;
    const int q0 = (qt_lo + it % nqt) * BN;
    const uint32_t st = ring + (it % STAGES) * 2 * T::tile;
    load_rows_sw<HD>(st, q + (size_t)bh * S * HD, q0, S, tid);
    load_rows_sw<HD>(st + T::tile, dO + (size_t)bh * S * HD, q0, S, tid);
    const int qp = q0 + (tid & (BN - 1));  // threads 0-63 copy lse, 64-127 delta
    const float* src = (tid < BN ? lse : delta) + (size_t)bh * S + min(qp, S - 1);
    cp_async4(smem_addr(stats + (it % STAGES) * 2 * BN + tid), src, qp < S ? 4 : 0);
  };

  if (n_it > 0) {
    load_rows_sw<HD>(sk, kb, k0, S, tid);
    load_rows_sw<HD>(sv, vb, k0, S, tid);
    load_stage(0);
  }
  cp_async_commit();

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // this iteration's stage has landed (and K, V at it = 0)
    fence_proxy_async();  // ... where wgmma reads it
    __syncthreads();      // ... for every thread; every warp is done with it - 1's stage
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int q0 = (qt_lo + it % nqt) * BN;
    const uint32_t sq = ring + (it % STAGES) * 2 * T::tile, sdo = sq + T::tile;
    const float* slse = stats + (it % STAGES) * 2 * BN;
    const float* sdel = slse + BN;

    // S^T = K Q^T and dP^T = V dO^T, keys as rows, in two groups: P^T is
    // formed while dP^T is in flight, dS^T while dV's product is
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<HD>(sk, kk), desc_k<HD>(sq, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<HD>(sv, kk), desc_k<HD>(sdo, kk), kk);
    wgmma_commit();
    wgmma_wait_one();  // S^T has landed, dP^T is in flight
    reg_fence(s);

    // masks, only on a tile where one can bite: rows past S, the diagonal, the window's edge
    const bool edge = q0 + BN > S || (causal && q0 < k0 + BM) ||
                      (window > 0 && q0 + BN - 1 >= k0 + window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = (i / 4) * 8 + 2 * t + (i & 1);  // q row in the tile
      float p = exp2f(s[i] * scale_log2 - slse[c] * kLog2e);
      if (edge) {
        const int kp = k0 + wr + g + ((i >> 1) & 1) * 8, qp = q0 + c;
        bool ok = qp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) p = 0.f;
      }
      s[i] = p;  // P^T
    }
    // P^T and dS^T as bf16 A operands, 16 q rows a k-step: the accumulator
    // layout of two 8-column blocks is the A layout of one k-step
    uint32_t pa[BN / 16][4], da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // dV += P^T dO, then dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<HD>(dva, pa[kk], desc_mn<HD>(sdo, kk));
    wgmma_commit();
    wgmma_wait_one();  // dP^T has landed, dV's product is in flight
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      dp[i] = s[i] * (dp[i] - sdel[(i / 4) * 8 + 2 * t + (i & 1)]) * scale;  // dS^T
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<HD>(dka, da[kk], desc_mn<HD>(sq, kk));
    wgmma_commit();
    wgmma_wait_all();  // before the next iteration's copy overwrites this stage
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dva);
    reg_fence(dka);
  }

  // the slice's fp32 partial dK, dV straight from the accumulators (keys
  // wr + g and wr + g + 8, columns 8 nb + 2 t and + 1), keys past S left out
  const size_t plane = (size_t)gridDim.x / slices * S * HD;  // one slice's dK or dV
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + wr + g + 8 * i;
    if (kp >= S) continue;
    const size_t row = ((size_t)bkv * S + kp) * HD + 2 * t;
    float* pk = part + slice * plane + row;
    float* pv = part + (slices + slice) * plane + row;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<float2*>(pk + nb * 8) =
          make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);
      *reinterpret_cast<float2*>(pv + nb * 8) =
          make_float2(dva[4 * nb + 2 * i], dva[4 * nb + 2 * i + 1]);
    }
  }
}

// dK and dV in bf16 from the slices' fp32 partials [2, slices, n], summed in
// slice order 0, 1, ... (the same bits every run), 4 elements a thread
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_dkdv_sum(const float4* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, long long n4, int slices) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n4) return;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float4* src = part + (long long)w * slices * n4 + i;
    float4 a = src[0];
    for (int j = 1; j < slices; ++j) {  // the partials in slice order
      const float4 b = src[j * n4];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>((w ? dv : dk) + 4 * i);
    out[0] = __floats2bfloat162_rn(a.x, a.y);
    out[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

// dQ of one (q row, 64-row q tile)
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int S, int group, int causal, int window, float scale,
             float scale_log2) {
  using T = Sw<HD>;
  constexpr int NO = HD / 2;  // accumulator floats of dQ a thread holds
  constexpr int NS = BN / 2;  // of a score tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t sq = smem_addr(smem), sdo = sq + T::tile, ring = sdo + T::tile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const bf16* kb = k + (size_t)(bh / group) * S * HD;
  const bf16* vb = v + (size_t)(bh / group) * S * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + warp * 16;  // this warp's first row in the sequence
  const int qr = qw0 + g;          // this thread's rows: qr and qr + 8

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
    const uint32_t st = ring + (it % STAGES) * 2 * T::tile;
    load_rows_sw<HD>(st, kb, kv0, S, tid);
    load_rows_sw<HD>(st + T::tile, vb, kv0, S, tid);
  };
  if (ntiles > 0) {
    load_rows_sw<HD>(sq, q + (size_t)bh * S * HD, q0, S, tid);
    load_rows_sw<HD>(sdo, dO + (size_t)bh * S * HD, q0, S, tid);
    load_stage(0);
  }
  cp_async_commit();

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();  // this K/V stage has landed (and Q, dO at it = 0)
    fence_proxy_async();  // ... where wgmma reads it
    __syncthreads();      // ... for every thread; every warp is done with it - 1's stage
    if (it + 1 < ntiles) load_stage(it + 1);
    cp_async_commit();

    const int kv0 = (kt_lo + it) * BN;
    const uint32_t sks = ring + (it % STAGES) * 2 * T::tile, svs = sks + T::tile;

    // S = Q K^T and dP = dO V^T, in two groups: P is formed while dP is in
    // flight
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<HD>(sq, kk), desc_k<HD>(sks, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<HD>(sdo, kk), desc_k<HD>(svs, kk), kk);
    wgmma_commit();
    wgmma_wait_one();
    reg_fence(s);

    // masks where one can bite for some row of this warp: keys past S, the
    // causal diagonal, the window's edge
    const bool bites = kv0 + BN > S || (causal && kv0 + BN - 1 > qw0) ||
                       (window > 0 && kv0 <= qw0 + 15 - window);
    uint32_t da[BN / 16][4];  // dS as bf16 A operands, 16 keys a k-step
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;  // this thread's row qr + 8 r
      float p = exp2f(s[i] * scale_log2 - lse2[r]);
      if (bites) {
        const int kp = kv0 + (i / 4) * 8 + 2 * t + (i & 1), qp = qr + 8 * r;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait_all();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;  // dS
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<HD>(dqa, da[kk], desc_mn<HD>(sks, kk));
    wgmma_commit();
    wgmma_wait_all();  // before the next iteration's copy overwrites this stage
    reg_fence(dqa);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr + 8 * i;
    if (qp >= S) continue;
    bf16* row = dq + ((size_t)bh * S + qp) * HD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(row + nb * 8) =
          __floats2bfloat162_rn(dqa[4 * nb + 2 * i], dqa[4 * nb + 2 * i + 1]);
  }
}

// CTAs over a kv row's group of q heads, kHeadsPerSlice each (the last may
// hold fewer)
int head_slices(int group) { return (group + kHeadsPerSlice - 1) / kHeadsPerSlice; }

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const void* lse, void* dq, void* dk, void* dv, void* delta, void* work, int BH,
           int S, int group, int causal, int window, float scale, cudaStream_t st) {
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
                           Sw<HD>::kv_bytes);
  if (e == cudaSuccess)  // the most shared memory, so that two CTAs fit an SM
    e = cudaFuncSetAttribute(flash_bwd_dkdv<HD>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int slices = head_slices(group);
  float* part = static_cast<float*>(work);
  flash_bwd_dkdv<HD><<<dim3(BH / group * slices, (S + BM - 1) / BM), NTHREADS,
                       Sw<HD>::kv_bytes, st>>>(
      qp, kp, vp, dop, lp, dl, part, S, group, slices, causal, window, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n4 = (long long)BH / group * S * HD / 4;
  flash_bwd_dkdv_sum<<<(unsigned)((n4 + kSumThreads - 1) / kSumThreads), kSumThreads, 0, st>>>(
      reinterpret_cast<const float4*>(part), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4,
      slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Sw<HD>::q_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<HD>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<HD><<<dim3(BH, (S + BM - 1) / BM), NTHREADS, Sw<HD>::q_bytes, st>>>(
      qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dq), S, group, causal, window, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of the workspace a call needs: the dK/dV slices' fp32 partials
extern "C" long long flash_attention_bwd_workspace_bytes(int BH, int S, int head_dim,
                                                         int group) {
  const int slices = group > 0 ? head_slices(group) : 1;
  return 2LL * slices * (BH / group) * S * head_dim * (long long)sizeof(float);
}

// q, o, dO, dq [BH, S, head_dim]; k, v, dk, dv [BH / group, S, head_dim]; lse
// (the forward's) and delta (written here) [BH, S] fp32; work, 16-byte
// aligned, of flash_attention_bwd_workspace_bytes; window <= 0 means no
// sliding window.  head_dim 16 or 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta,
                                          void* work, int BH, int S, int head_dim, int group,
                                          int causal, int window, float scale, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || BH > 65535 ||
      (S + BM - 1) / BM > 65535 || (long long)BH * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 16)
    return launch<16>(q, k, v, o, dO, lse, dq, dk, dv, delta, work, BH, S, group, causal,
                      window, scale, s);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, dO, lse, dq, dk, dv, delta, work, BH, S, group, causal,
                       window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
