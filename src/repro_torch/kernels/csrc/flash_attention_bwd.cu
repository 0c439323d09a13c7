// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of causal
// and/or sliding-window GQA attention from the forward's output and its
// per-row logsumexp, bf16 in and out, fp32 accumulation, at a q/k head dim
// HDQK and a v head dim HDV of its own (MLA: 96 and 64, 192 and 128).
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
// - a pre-pass writes delta [BH, S] fp32 from o and dO (HDV wide), a group
//   of lanes per row;
// - the dK/dV kernel: one CTA per (kv row, 64-key tile, slice of
//   kHeadsPerSlice q heads of the group), launched heaviest causal key tile
//   first, one warpgroup a column half of dK and dV (one warpgroup up to
//   128 columns).  It walks its heads and, for each, the 64-row q tiles
//   inside the causal / window frontier, with the next (head, q tile)'s Q,
//   dO, lse and delta in flight by cp.async into a two-stage ring.  S^T = K Q^T (over HDQK) and dP^T = V dO^T (over HDV)
//   come out of wgmma m64n64k16 with both operands in shared memory and keys
//   as rows, so P^T and dS^T, packed to bf16 in registers, are already the A
//   operands of dV += P^T dO and dK += dS^T Q (m64n{W}k16, dO and Q read
//   transposed from shared memory).  The products go in commit groups so
//   that P^T is formed while dP^T's product runs, and dS^T while dV's.  dK
//   and dV stay in registers (fp32) across the slice, and the CTA writes them
//   as fp32 partials to a workspace [slices, BH/G, S, HDV] (dV) followed by
//   [slices, BH/G, S, HDQK] (dK);
// - a sum pass adds the partials in slice order 0, 1, ... into bf16 dK, dV;
// - the dQ kernel: one CTA per (q row, 64-row q tile), heaviest first, one
//   warpgroup a column half of dQ, walks the K/V tiles inside the frontier
//   (as the forward does) with the next in flight, recomputes S = Q K^T and
//   dP = dO V^T (P formed while dP's product runs) and keeps dQ += dS K in
//   registers, all three products on wgmma.
//
// Every tile sits in shared memory in the swizzled layout wgmma's
// descriptors read (see Sw), copied there by cp.async.  dK and dV take 128
// fp32 registers a thread at hd 128, S^T and dP^T 64 more: the dK/dV kernel
// is held to 255 registers, which is why one warpgroup owns 64 keys and a q
// tile is 64 rows.  Above 128 columns (hd 256; q/k 192 beside v 128) dK and
// dV would take 256 and 160 registers: each of two warpgroups of the CTA
// accumulates one column half of dK and dV (and of dQ) from the same
// shared tiles, and each recomputes S^T and dP^T over the full contraction.
// That costs the dK/dV kernel half again its products (S^T and dP^T twice),
// where sharing S^T and dP^T through shared memory would not; each
// warpgroup runs the code of the one-warpgroup kernel as it is, which this
// simple version is for.  The CTA holds 198,656 B of shared memory at hd
// 256 (one an SM): as two CTAs of one warpgroup each, split over the grid,
// an SM held one warpgroup and each CTA loaded the tiles for itself
// (PERF.md section 6 times both).
//
// A head dim that is no multiple of wgmma's k-step (16) is padded inside:
// 120 runs as 128, 24 as 32, the pad columns zero-filled by cp.async in the
// shared tiles (so they add nothing to S^T or dP^T) and never written out.
// A row of 96 or 192 columns (192 or 384 bytes) is no whole number of
// 128-byte blocks: those tiles take the 64-byte swizzle.
//
// Rows past S are zero-filled and masked: a q row past S must not reach
// dK/dV (its lse and delta are zero-filled, not its statistics), a key past
// S must not reach dQ.
//
// smem per CTA: dK/dV 100,352 B, dQ 99,328 B at hd 128 and 120 (two CTAs
// an SM); 198,656 and 197,632 B at hd 256 and 124,928 and 123,904 B at
// (192, 128) (one CTA of two warpgroups an SM); 63,488 and 62,464 B at
// (96, 64); 51,200 and 50,176 B at 64 (Pair's kv_bytes, q_bytes).
//
// Layout: q, dQ [BH, S, HDQK]; o, dO [BH, S, HDV]; k, dK [BH/group, S,
// HDQK]; v, dV [BH/group, S, HDV], all contiguous bf16; lse, delta [BH, S]
// fp32, lse in natural-log units (the forward's).  (HDQK, HDV) is a pair of
// the forward's (flash_attention.cu).  C interface (ctypes): returns
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

// [64, P] bf16 tiles (P the padded head dim) in the layout wgmma's
// descriptors read: the columns in blocks of R bytes, each block 64 rows of R
// bytes, with the 16-byte chunks of a row permuted by the R-byte swizzle
// (address bits [4, 7) ^= bits [7, 10), as many of them as R has chunks);
// every tile 1024-byte aligned.  R is the largest of 128, 64 and 32 bytes
// that divides the W columns a warpgroup accumulates, so a column half
// starts on a block
template <int P, int W>
struct Sw {
  static constexpr int R = W * 2 % 128 == 0 ? 128 : W * 2 % 64 == 0 ? 64 : 32;
  static_assert(W * 2 % R == 0 && P % W == 0, "a row is whole 32-, 64- or 128-byte blocks");
  static constexpr int block = 64 * R;                 // one column block
  static constexpr int tile = 64 * P * (int)sizeof(bf16);
  static constexpr uint64_t mode = R == 128 ? 1 : R == 64 ? 2 : 3;  // the descriptor's swizzle
  // byte offset of 16-byte chunk c of row r
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t o = r * R + (c * 16) % R;
    return (c * 16 / R) * block + (o ^ (((o >> 7) & (R / 16 - 1)) << 4));
  }
};

// the tiling of q/k head dim HDQK and v head dim HDV
template <int HDQK, int HDV>
struct Pair {
  // the head dims padded to wgmma's k-step (120 -> 128, 24 -> 32)
  static constexpr int PQ = (HDQK + 15) / 16 * 16, PV = (HDV + 15) / 16 * 16;
  // column halves of dK, dV and dQ, one warpgroup of the CTA each: two above
  // 128 columns
  static constexpr int kSplit = PQ > 128 ? 2 : 1;
  static constexpr int WQ = PQ / kSplit, WV = PV / kSplit;  // columns a warpgroup accumulates
  static constexpr int kThreads = NTHREADS * kSplit;        // threads of a CTA
  static constexpr int kMinCtas = kSplit == 1 ? 2 : 1;      // CTAs an SM, for 255 registers
  using TQ = Sw<PQ, WQ>;  // Q and K tiles
  using TV = Sw<PV, WV>;  // dO and V tiles
  static constexpr int stage = TQ::tile + TV::tile;
  // dK/dV: K, V, then STAGES x (Q, dO), then STAGES x (lse[64], delta[64]),
  // and 1024 bytes to align the base
  static constexpr int kv_bytes = (1 + STAGES) * stage + STAGES * 2 * BN * 4 + 1024;
  // dQ: Q, dO, then STAGES x (K, V), and the same 1024
  static constexpr int q_bytes = (1 + STAGES) * stage + 1024;
  static_assert(WQ <= 128 && WV <= 128, "at most 128 accumulator columns a CTA");
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
template <class T>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + kk * 32 / T::R * T::block + kk * 32 % T::R, 16, 8 * T::R, T::mode);
}

// an MN-major operand (the tile's rows are K, its columns N) from column c0
// (a block's first): k-step kk's 16 rows; column blocks (along N) a block
// apart, 8-row groups R * 8 bytes
template <class T>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c0) {
  return desc(tile + c0 * 2 / T::R * T::block + kk * 16 * T::R, T::block, 8 * T::R, T::mode);
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
// d[64 x N] += A B at N = 16, 32, 64, 96, 128: A from registers (each warp's
// 16 rows in the A layout of mma.sync m16n8k16), B from shared memory by
// descriptor, MN-major (trans 1)
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
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// the m64n{N}k16 instruction for the N columns a warpgroup accumulates
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else {
    static_assert(N == 16, "an m64n{N}k16 instruction for each width");
    wgmma_rs_n16(d, a, b);
  }
}

// 64 rows of a [n, HD] matrix from row r0 into a swizzled tile T at dst (T's
// padded width), by cp.async; rows past n and the pad columns past HD are
// zero-filled, a row's source clamped to a valid row
template <int HD, class T, int THREADS>
__device__ __forceinline__ void load_rows_sw(uint32_t dst, const bf16* src, int r0, int n,
                                             int tid) {
  constexpr int VPR = T::tile / 64 / 16;  // 16-byte vectors per (padded) row
  constexpr int CHUNKS = 64 * VPR;
  static_assert(CHUNKS % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / VPR, c = i % VPR;
    const int gr = r0 + r;
    const int bytes = gr < n && c * 8 < HD ? 16 : 0;  // zeros past the end and in the pad
    cp_async16(dst + T::at(r, c), src + (size_t)min(gr, n - 1) * HD + c * 8, bytes);
  }
}

// lanes that share a row of vpr 16-byte vectors in the delta pass: a power
// of two, at most a warp
__host__ __device__ constexpr int lanes_per_row(int vpr) {
  return vpr >= 32 ? 32 : vpr >= 16 ? 16 : vpr >= 8 ? 8 : vpr >= 4 ? 4 : vpr >= 2 ? 2 : 1;
}

// delta[row] = sum(dO[row] * O[row]) in fp32 over the HDV columns of o and
// dO, a group of LPR lanes per row
template <int HDQK, int HDV>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                float* __restrict__ delta, int rows) {
  constexpr int VPR = HDV / 8;  // 16-byte vectors of a row of o or dO
  constexpr int LPR = lanes_per_row(HDV / 8);
  constexpr int RPW = 32 / LPR;  // rows per warp
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * RPW + lane / LPR;
  float s = 0.f;
  if (row < rows) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * HDV);
    const uint4* drow = reinterpret_cast<const uint4*>(dO + row * HDV);
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

// dK and dV of one (kv row, 64-key tile, slice of the group's heads), a
// column half of each a warpgroup above 128 columns
template <int HDQK, int HDV>
__global__ void __launch_bounds__(Pair<HDQK, HDV>::kThreads, Pair<HDQK, HDV>::kMinCtas)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ part, int S, int group, int slices, int causal, int window,
               float scale, float scale_log2) {
  using L = Pair<HDQK, HDV>;
  using TQ = typename L::TQ;
  using TV = typename L::TV;
  constexpr int NK = L::WQ / 2, NV = L::WV / 2;  // accumulator floats of dK, of dV a thread holds
  constexpr int NS = BN / 2;                     // of a score tile
  constexpr int NT = L::kThreads;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t sk = smem_addr(smem), sv = sk + TQ::tile, ring = sv + TV::tile;
  float* const stats = reinterpret_cast<float*>(smem + (1 + STAGES) * L::stage);

  const int bkv = blockIdx.x / slices, slice = blockIdx.x % slices;
  // the thread in its warpgroup, and the warpgroup's column half
  const int tid = threadIdx.x, wtid = L::kSplit == 1 ? tid : tid % NTHREADS;
  const int half = L::kSplit == 1 ? 0 : tid / NTHREADS;
  const int c0q = half * L::WQ, c0v = half * L::WV;      // its first column of dK, of dV
  const int h0 = slice * kHeadsPerSlice;                 // the slice's first head in the group
  const int nh = min(kHeadsPerSlice, group - h0);        // and its number of heads
  const int k0 = blockIdx.y * BM;  // heaviest causal key tiles first
  const bf16* kb = k + (size_t)bkv * S * HDQK;
  const bf16* vb = v + (size_t)bkv * S * HDV;
  const int warp = wtid >> 5, lane = tid & 31;  // the warp in its warpgroup
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
    const uint32_t st = ring + (it % STAGES) * L::stage;
    load_rows_sw<HDQK, TQ, NT>(st, q + (size_t)bh * S * HDQK, q0, S, tid);
    load_rows_sw<HDV, TV, NT>(st + TQ::tile, dO + (size_t)bh * S * HDV, q0, S, tid);
    if (L::kSplit == 1 || tid < 2 * BN) {  // threads 0-63 copy lse, 64-127 delta
      const int qp = q0 + (tid & (BN - 1));
      const float* src = (tid < BN ? lse : delta) + (size_t)bh * S + min(qp, S - 1);
      cp_async4(smem_addr(stats + (it % STAGES) * 2 * BN + tid), src, qp < S ? 4 : 0);
    }
  };

  if (n_it > 0) {
    load_rows_sw<HDQK, TQ, NT>(sk, kb, k0, S, tid);
    load_rows_sw<HDV, TV, NT>(sv, vb, k0, S, tid);
    load_stage(0);
  }
  cp_async_commit();

  float dka[NK], dva[NV];
#pragma unroll
  for (int i = 0; i < NK; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) dva[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // this iteration's stage has landed (and K, V at it = 0)
    fence_proxy_async();  // ... where wgmma reads it
    __syncthreads();      // ... for every thread; every warp is done with it - 1's stage
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();

    const int q0 = (qt_lo + it % nqt) * BN;
    const uint32_t sq = ring + (it % STAGES) * L::stage, sdo = sq + TQ::tile;
    const float* slse = stats + (it % STAGES) * 2 * BN;
    const float* sdel = slse + BN;

    // S^T = K Q^T (over HDQK) and dP^T = V dO^T (over HDV), keys as rows, in
    // two groups: P^T is formed while dP^T is in flight, dS^T while dV's
    // product is
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::PQ / 16; ++kk)
      wgmma_ss_n64(s, desc_k<TQ>(sk, kk), desc_k<TQ>(sq, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < L::PV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<TV>(sv, kk), desc_k<TV>(sdo, kk), kk);
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

    // dV += P^T dO, then dK += dS^T Q, over this warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<L::WV>(dva, pa[kk], desc_mn<TV>(sdo, kk, c0v));
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
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<L::WQ>(dka, da[kk], desc_mn<TQ>(sq, kk, c0q));
    wgmma_commit();
    wgmma_wait_all();  // before the next iteration's copy overwrites this stage
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dva);
    reg_fence(dka);
  }

  // the slice's fp32 partials of this warpgroup's columns of dK and dV, straight
  // from the accumulators (keys wr + g and wr + g + 8, columns c0 + 8 nb +
  // 2 t and + 1); keys past S and pad columns left out.  The workspace holds
  // every slice's dV plane, then every slice's dK plane
  const size_t rows = (size_t)gridDim.x / slices * S;  // rows of one plane
  float* const pv = part + ((size_t)slice * rows + (size_t)bkv * S) * HDV;
  float* const pk =
      part + (size_t)slices * rows * HDV + ((size_t)slice * rows + (size_t)bkv * S) * HDQK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + wr + g + 8 * i;
    if (kp >= S) continue;
    float* const rv = pv + (size_t)kp * HDV + c0v + 2 * t;
    float* const rk = pk + (size_t)kp * HDQK + c0q + 2 * t;
#pragma unroll
    for (int nb = 0; nb < L::WV / 8; ++nb)
      if (c0v + nb * 8 < HDV)  // the real columns of this warpgroup's dV
        *reinterpret_cast<float2*>(rv + nb * 8) =
            make_float2(dva[4 * nb + 2 * i], dva[4 * nb + 2 * i + 1]);
#pragma unroll
    for (int nb = 0; nb < L::WQ / 8; ++nb)
      if (c0q + nb * 8 < HDQK)  // ... and of its dK
        *reinterpret_cast<float2*>(rk + nb * 8) =
            make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);  // dK
  }
}

// dV and dK in bf16 from the slices' fp32 partials (every slice's dV plane
// of n4v float4s, then every slice's dK plane of n4k), summed in slice order
// 0, 1, ... (the same bits every run), 4 elements a thread
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_dkdv_sum(const float4* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, long long n4k, long long n4v, int slices) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n4v + n4k) return;
  const bool is_v = i < n4v;
  const long long n4 = is_v ? n4v : n4k, e = is_v ? i : i - n4v;
  const float4* src = part + (is_v ? 0 : slices * n4v) + e;
  float4 a = src[0];
  for (int j = 1; j < slices; ++j) {  // the partials in slice order
    const float4 b = src[j * n4];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>((is_v ? dv : dk) + 4 * e);
  out[0] = __floats2bfloat162_rn(a.x, a.y);
  out[1] = __floats2bfloat162_rn(a.z, a.w);
}

// dQ of one (q row, 64-row q tile), a column half of it a warpgroup above
// 128 columns
template <int HDQK, int HDV>
__global__ void __launch_bounds__(Pair<HDQK, HDV>::kThreads, Pair<HDQK, HDV>::kMinCtas)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int S, int group, int causal, int window, float scale,
             float scale_log2) {
  using L = Pair<HDQK, HDV>;
  using TQ = typename L::TQ;
  using TV = typename L::TV;
  constexpr int NO = L::WQ / 2;  // accumulator floats of dQ a thread holds
  constexpr int NS = BN / 2;     // of a score tile
  constexpr int NT = L::kThreads;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t sq = smem_addr(smem), sdo = sq + TQ::tile, ring = sdo + TV::tile;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const bf16* kb = k + (size_t)(bh / group) * S * HDQK;
  const bf16* vb = v + (size_t)(bh / group) * S * HDV;
  // the thread in its warpgroup, and the warpgroup's first column of dQ
  const int tid = threadIdx.x, wtid = L::kSplit == 1 ? tid : tid % NTHREADS;
  const int c0q = L::kSplit == 1 ? 0 : tid / NTHREADS * L::WQ;
  const int warp = wtid >> 5, lane = tid & 31;  // the warp in its warpgroup
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
    const uint32_t st = ring + (it % STAGES) * L::stage;
    load_rows_sw<HDQK, TQ, NT>(st, kb, kv0, S, tid);
    load_rows_sw<HDV, TV, NT>(st + TQ::tile, vb, kv0, S, tid);
  };
  if (ntiles > 0) {
    load_rows_sw<HDQK, TQ, NT>(sq, q + (size_t)bh * S * HDQK, q0, S, tid);
    load_rows_sw<HDV, TV, NT>(sdo, dO + (size_t)bh * S * HDV, q0, S, tid);
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
    const uint32_t sks = ring + (it % STAGES) * L::stage, svs = sks + TQ::tile;

    // S = Q K^T and dP = dO V^T, in two groups: P is formed while dP is in
    // flight
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::PQ / 16; ++kk)
      wgmma_ss_n64(s, desc_k<TQ>(sq, kk), desc_k<TQ>(sks, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < L::PV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<TV>(sdo, kk), desc_k<TV>(svs, kk), kk);
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

    // dQ += dS K, over this warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<L::WQ>(dqa, da[kk], desc_mn<TQ>(sks, kk, c0q));
    wgmma_commit();
    wgmma_wait_all();  // before the next iteration's copy overwrites this stage
    reg_fence(dqa);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qr + 8 * i;
    if (qp >= S) continue;
    bf16* row = dq + ((size_t)bh * S + qp) * HDQK + c0q + 2 * t;
#pragma unroll
    for (int nb = 0; nb < L::WQ / 8; ++nb)
      if (c0q + nb * 8 < HDQK)  // the real columns of this warpgroup's dQ
        *reinterpret_cast<__nv_bfloat162*>(row + nb * 8) =
            __floats2bfloat162_rn(dqa[4 * nb + 2 * i], dqa[4 * nb + 2 * i + 1]);
  }
}

// CTAs over a kv row's group of q heads, kHeadsPerSlice each (the last may
// hold fewer)
int head_slices(int group) { return (group + kHeadsPerSlice - 1) / kHeadsPerSlice; }

template <int HDQK, int HDV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const void* lse, void* dq, void* dk, void* dv, void* delta, void* work, int BH,
           int S, int group, int causal, int window, float scale, cudaStream_t st) {
  using L = Pair<HDQK, HDV>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dO);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  constexpr int rows_per_cta = kWarps * (32 / lanes_per_row(HDV / 8));
  const int rows = BH * S;
  flash_bwd_delta<HDQK, HDV><<<(rows + rows_per_cta - 1) / rows_per_cta, NTHREADS, 0, st>>>(
      static_cast<const bf16*>(o), dop, dl, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv<HDQK, HDV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kv_bytes);
  if (e == cudaSuccess)  // the most shared memory, so that two CTAs fit an SM where they can
    e = cudaFuncSetAttribute(flash_bwd_dkdv<HDQK, HDV>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int slices = head_slices(group);
  float* part = static_cast<float*>(work);
  flash_bwd_dkdv<HDQK, HDV><<<dim3(BH / group * slices, (S + BM - 1) / BM), L::kThreads,
                              L::kv_bytes, st>>>(
      qp, kp, vp, dop, lp, dl, part, S, group, slices, causal, window, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows_kv = (long long)BH / group * S;
  const long long n4k = rows_kv * HDQK / 4, n4v = rows_kv * HDV / 4;
  flash_bwd_dkdv_sum<<<(unsigned)((n4k + n4v + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                       st>>>(reinterpret_cast<const float4*>(part), static_cast<bf16*>(dk),
                             static_cast<bf16*>(dv), n4k, n4v, slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq<HDQK, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::q_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<HDQK, HDV>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<HDQK, HDV><<<dim3(BH, (S + BM - 1) / BM), L::kThreads, L::q_bytes,
                            st>>>(qp, kp, vp, dop, lp, dl, static_cast<bf16*>(dq), S, group,
                                  causal, window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of the workspace a call needs: the dK/dV slices' fp32 partials
extern "C" long long flash_attention_bwd_workspace_bytes(int BH, int S, int head_dim,
                                                         int head_dim_v, int group) {
  if (group <= 0) return 0;
  return (long long)head_slices(group) * (BH / group) * S * (head_dim + head_dim_v) *
         (long long)sizeof(float);
}

// q, dq [BH, S, head_dim]; o, dO [BH, S, head_dim_v]; k, dk [BH / group, S,
// head_dim]; v, dv [BH / group, S, head_dim_v]; lse (the forward's) and delta
// (written here) [BH, S] fp32; work, 16-byte aligned, of
// flash_attention_bwd_workspace_bytes; window <= 0 means no sliding window.
// (head_dim, head_dim_v) is one of the forward's pairs.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta,
                                          void* work, int BH, int S, int head_dim,
                                          int head_dim_v, int group, int causal, int window,
                                          float scale, void* stream) {
  if (BH <= 0 || S <= 0 || group <= 0 || BH % group != 0 || BH > 65535 ||
      (S + BM - 1) / BM > 65535 || (long long)BH * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_CASE(QK, V)                                                                     \
  if (head_dim == QK && head_dim_v == V)                                                    \
    return launch<QK, V>(q, k, v, o, dO, lse, dq, dk, dv, delta, work, BH, S, group, causal, \
                         window, scale, s);
  BWD_CASE(16, 16)
  BWD_CASE(64, 64)
  BWD_CASE(120, 120)
  BWD_CASE(128, 128)
  BWD_CASE(256, 256)
  BWD_CASE(24, 16)
  BWD_CASE(96, 64)
  BWD_CASE(192, 128)
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
