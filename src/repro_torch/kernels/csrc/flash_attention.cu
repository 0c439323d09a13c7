// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an online softmax, bf16 in and out, fp32 state.
//
// Replaces the TPU kernel `flash_attention_kernel` / `flash_attention_pallas`
// of src/repro/kernels/flash_attention.py.  On the TPU the KV-block grid
// dimension runs in order on one core and the softmax state (m, l, acc)
// lives in VMEM scratch across grid steps.  Here CTAs run in parallel and in
// no order, so one CTA owns one (batch*head, q tile) and walks the KV tiles
// in a loop of its own.  GQA maps q-head row `bh` to kv row `bh / group`, as
// the Pallas index maps do.  KV tiles past the causal frontier or before the
// window are never visited (the Pallas kernel's `needed` test).  Unlike the
// Pallas kernel, the ragged edge is masked: Sq and Skv need not be
// multiples of the tiles (a served prompt rarely is).
//
// Bound on the H100: per q-head a causal pass does ~2*S*S*hd flops and
// moves ~4*S*hd bytes (q in, o out, bf16; K/V are shared by the group), so
// ~S/2 flop/byte.  At the Yi prefill shape (S = 512) that is just under the
// ~295 flop/byte ridge: bytes bind, barely; longer prompts are bound by the
// tensor cores.  The design (FlashAttention-2's, on mma.sync) keeps every
// intermediate in registers and every load in flight under the math:
//
// - each warp owns 16 q rows; Q is loaded once into shared memory and,
//   up to hd 128, held as ldmatrix A-fragments for the whole KV loop; at hd
//   256 those fragments (64 registers) would not fit beside the output
//   accumulator (128), so Q is re-read by ldmatrix at every k-step, and KV
//   tiles are 32 rows instead of 64 (scores: 16 registers, not 32; shared
//   memory 101,376 B, so two CTAs fit an SM);
// - a head dim that is no multiple of mma's k-step (16) is padded inside
//   the kernel: hd 120 runs as 128, the 16th 16-byte vector of each shared
//   row zero-filled by cp.async, and only the 120 real columns written back;
// - the value head dim HDV may differ from the query/key one HDQK (MLA:
//   q/k 96, v 64; q/k 192, v 128): Q K^T runs over HDQK's k-steps, V's
//   tiles, P V and the output fragments cover HDV's columns only, so V and
//   O move no padding; at q/k 192 that pair takes hd 256's path (Q re-read
//   from shared memory at every k-step, 32-key tiles: 168 registers,
//   68,608 B): with Q's fragments held and 64-key tiles it spilled at 255
//   registers and ran 6.6% slower on the H100, and with Q re-read and
//   64-key tiles it gained 1.3% at 250 registers (PERF.md section 6);
// - S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 accumulate), K's
//   B-fragments come from shared memory through ldmatrix, and the scores
//   stay in the accumulator fragments: each thread holds 2 rows x 2
//   columns of every 16x8 block;
// - the online softmax works on those fragments: a row's max takes two
//   quad shuffles (xor 1, 2); each thread keeps m and its own share of l
//   for its 2 rows, and the shares of l are summed over the quad once, at
//   the end; scores are kept times scale * log2(e), so exp is one exp2f;
// - P never leaves registers: the accumulator layout of m16n8k16 is the
//   A-operand layout of the next product, so the probabilities are packed
//   pairwise to bf16x2 and O += P V runs straight from them, V's
//   B-fragments from ldmatrix.trans; O is rescaled in registers;
// - K and V tiles arrive by cp.async (16-byte copies, rows past Skv
//   zero-filled) into a ring of 2 stages: tile j+1's K is in flight while
//   tile j's softmax and P V run, its V while the next scores do;
// - shared rows are padded by 16 bytes, so the 8 row addresses of each
//   ldmatrix phase fall on distinct banks;
// - masks are applied only on the tiles where they can bite: the causal
//   diagonal, the window's edge and the last (ragged) KV tile;
// - q tiles are launched heaviest first (batch*head is the fast grid
//   axis, q tiles in reverse), so the last wave holds the shortest rows.
//
// What did not pay on the H100: 32 q rows per warp (each K/V fragment
// feeding two m tiles) needs more than 255 registers at hd 128 and spills;
// fewer, larger CTAs lose at the serving shapes; skipping the 16-key
// blocks that the causal mask removes whole, by a warp-uniform test inside
// the unrolled products, cost more than the products it saved.  The next
// design for prompts bound by the tensor cores is wgmma with TMA.
//
// Training (models/flash.py's forward, `_fwd_impl`) also needs each row's
// logsumexp: the instance with kLse = true writes lse [BH, Sq] fp32 in
// natural-log units (m + log l, the reference's) from the epilogue, where m
// is held in log2 units, at every head-dim pair the serving instance takes
// (the backward kernel, flash_attention_bwd.cu, takes the same pairs).  The
// serving instance (kLse = false) compiles to the code it had before, and
// its C entry point is unchanged.
//
// Layout: q [BH, Sq, HDQK], k [BH/group, Skv, HDQK], v [BH/group, Skv, HDV],
// o [BH, Sq, HDV], all contiguous bf16.  C interface (ctypes): returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;             // warps per CTA, 16 q rows each
constexpr int BQ = 16 * kWarps;       // q rows per CTA
constexpr int NTHREADS = 32 * kWarps;
constexpr int STAGES = 2;             // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e30f;        // masked score, as in the reference
constexpr float kNegL2 = kNeg * kLog2e;  // the same in the kernel's log2 units

// a shared-memory row of head dim HD (the row length in device memory)
template <int HD>
struct Row {
  // the head dim padded to mma's k-step (120 -> 128, 24 -> 32): the pad
  // columns are zeros in shared memory and are never written out
  static constexpr int P = (HD + 15) / 16 * 16;
  // row stride in bf16: 16 bytes of pad put the 8 rows of an ldmatrix
  // phase on 8 distinct groups of 4 banks
  static constexpr int LD = P + 8;
};

// the tiling of q/k head dim HDQK and v head dim HDV
template <int HDQK, int HDV>
struct Tile {
  static constexpr int HDPQ = Row<HDQK>::P, LDQ = Row<HDQK>::LD;
  static constexpr int HDPV = Row<HDV>::P, LDV = Row<HDV>::LD;
  static constexpr int BK = (HDPQ > HDPV ? HDPQ : HDPV) > 128 ? 32 : 64;  // kv rows per tile
  static constexpr bool kHoldQ = HDPQ <= 128;  // Q's fragments kept in registers
  static constexpr int k_stage = sizeof(bf16) * BK * LDQ;  // bytes of one K tile
  static constexpr int v_stage = sizeof(bf16) * BK * LDV;  // ... and of one V tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + sizeof(bf16) * BQ * LDQ;
  static constexpr int v_off = k_off + STAGES * k_stage;
  static constexpr int bytes = v_off + STAGES * v_stage;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ROWS rows of a [n, HD] matrix from row r0 into shared memory at dst
// (stride Row<HD>::LD, Row<HD>::P columns), by cp.async; rows past n are
// zero-filled, their source clamped to a valid row, and so are the pad
// vectors past HD
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int r0, int n,
                                          int tid) {
  constexpr int VPR = Row<HD>::P / 8;  // 16-byte vectors per shared row
  constexpr int CHUNKS = ROWS * VPR;
#pragma unroll
  for (int j = 0; j < (CHUNKS + NTHREADS - 1) / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
    if (CHUNKS % NTHREADS == 0 || i < CHUNKS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int gr = r0 + r;
      const int bytes = gr < n && c < HD ? 16 : 0;  // zeros past the end and in the pad
      cp_async16(dst + (r * Row<HD>::LD + c) * (int)sizeof(bf16),
                 src + (size_t)min(gr, n - 1) * HD + c, bytes);
    }
  }
}

template <int HDQK, int HDV, bool kLse>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int group, int causal, int window, float scale_log2) {
  using L = Tile<HDQK, HDV>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV;
  constexpr int BK = L::BK;
  constexpr int NS = BK / 8;        // 16x8 score blocks per warp and tile
  constexpr int NO = L::HDPV / 8;   // 16x8 output blocks per warp
  constexpr int KQ = L::HDPQ / 16;  // k-steps of Q K^T

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_addr(smem + L::q_off);
  const uint32_t sk = smem_addr(smem + L::k_off);
  const uint32_t sv = smem_addr(smem + L::v_off);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const bf16* qb = q + (size_t)bh * Sq * HDQK;
  const bf16* kb = k + (size_t)(bh / group) * Skv * HDQK;
  const bf16* vb = v + (size_t)(bh / group) * Skv * HDV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wr = warp * 16;               // this warp's first row in the tile
  const int qw0 = q0 + wr;                // ... and in the sequence
  const int qr = qw0 + g;                 // this thread's rows: qr and qr + 8

  // KV tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int nk = (Skv + BK - 1) / BK;
  const int kt_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int lo = q0 - window + 1;
  const int kt_lo = (window > 0 && lo > 0) ? lo / BK : 0;
  const int ntiles = kt_hi - kt_lo;

  // groups in commit order: Q + K(0), V(0), then K(j+1), V(j+1) per tile j
  if (ntiles > 0) {
    load_rows<HDQK, BQ>(sq, qb, q0, Sq, tid);
    load_rows<HDQK, BK>(sk, kb, kt_lo * BK, Skv, tid);
    cp_async_commit();
    load_rows<HDV, BK>(sv, vb, kt_lo * BK, Skv, tid);
    cp_async_commit();
  }

  // each lane's ldmatrix row address, in bytes from its tile's start
  const uint32_t q_lane = ((wr + (lane & 15)) * LDQ + (lane >> 4) * 8) * sizeof(bf16);
  const uint32_t k_lane = (((lane & 7) + ((lane >> 4) << 3)) * LDQ + ((lane >> 3) & 1) * 8) *
                          sizeof(bf16);
  const uint32_t v_lane = (((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8) *
                          sizeof(bf16);

  uint32_t qf[L::kHoldQ ? KQ : 1][4];  // Q's A-fragments, where they are held
  float acc[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m[2] = {kNegL2, kNegL2};  // running max of rows qr, qr + 8 (log2 units)
  float l[2] = {0.f, 0.f};        // this thread's share of their sums

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (kt_lo + it) * BK;
    const uint32_t cur = (it % STAGES) * L::k_stage, cur_v = (it % STAGES) * L::v_stage;
    const uint32_t nxt = ((it + 1) % STAGES) * L::k_stage,
                   nxt_v = ((it + 1) % STAGES) * L::v_stage;

    cp_async_wait<1>();  // K tile it has landed (and Q, at it = 0)
    __syncthreads();     // ... for every thread; every warp is done with tile it - 1
    if constexpr (L::kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) ldsm_x4(qf[kk], sq + q_lane + kk * 32);
      }
    }

    // S[16 x BK] = Q K^T for this warp's rows
    float s[NS][4];
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (L::kHoldQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, sq + q_lane + kk * 32);
      }
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, sk + cur + k_lane + (p * 16 * LDQ) * sizeof(bf16) + kk * 32);
        mma16816(s[2 * p], a, b[0], b[1]);
        mma16816(s[2 * p + 1], a, b[2], b[3]);
      }
    }

    // the next K tile, into the stage every warp finished before the barrier
    if (it + 1 < ntiles) load_rows<HDQK, BK>(sk + nxt, kb, k0 + BK, Skv, tid);
    cp_async_commit();

#pragma unroll
    for (int nb = 0; nb < NS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale_log2;

    // masks, only on a tile where one can bite for some row of this warp
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 15 - window);
    if (edge) {
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nb * 8 + 2 * t + (e & 1);
          const int qp = qr + (e >> 1) * 8;
          if (kp >= Skv) {
            s[nb][e] = -INFINITY;  // ragged edge: past the end of the keys, never attended
          } else {
            bool ok = causal ? (kp <= qp) : true;
            if (window > 0) ok = ok && (kp > qp - window);
            if (!ok) s[nb][e] = kNegL2;
          }
        }
      }
    }

    // online softmax on the fragments: row i of this thread is qr + 8 i
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        s[nb][2 * i] = exp2f(s[nb][2 * i] - mx);
        s[nb][2 * i + 1] = exp2f(s[nb][2 * i + 1] - mx);
        sum += s[nb][2 * i] + s[nb][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) { acc[nb][2 * i] *= alpha; acc[nb][2 * i + 1] *= alpha; }
    }

    cp_async_wait<1>();  // V tile it has landed (K tile it + 1 may be in flight)
    __syncthreads();

    // O[16 x HDV] += P[16 x BK] V[BK x HDV], P packed from the score fragments
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * j][0], s[2 * j][1]), pack_bf16x2(s[2 * j][2], s[2 * j][3]),
          pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(b, sv + cur_v + v_lane + (j * 16 * LDV + p * 16) * sizeof(bf16));
        mma16816(acc[2 * p], pa, b[0], b[1]);
        mma16816(acc[2 * p + 1], pa, b[2], b[3]);
      }
    }

    // the next V tile, into the stage every warp finished before the last barrier
    if (it + 1 < ntiles) load_rows<HDV, BK>(sv + nxt_v, vb, k0 + BK, Skv, tid);
    cp_async_commit();
  }

  // epilogue: the quad's shares of l summed, O / max(l, 1e-30) written as
  // bf16x2 straight from the fragments, the HDV real columns only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = qr + 8 * i;
    if (qp >= Sq) continue;
    li = fmaxf(li, 1e-30f);
    if constexpr (kLse) {  // m is quad-uniform: one thread of the quad writes the row's lse
      if (t == 0) lse[(size_t)bh * Sq + qp] = (m[i] + log2f(li)) * kLn2;
    }
    bf16* orow = o + ((size_t)bh * Sq + qp) * HDV + 2 * t;
#pragma unroll
    for (int nb = 0; nb < HDV / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * i] / li, acc[nb][2 * i + 1] / li);
  }
}

template <int HDQK, int HDV, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int Sq,
           int Skv, int group, int causal, int window, float scale, cudaStream_t stream) {
  const int bytes = Tile<HDQK, HDV>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HDQK, HDV, kLse>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<HDQK, HDV, kLse><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, Sq, Skv, group, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int Sq, int Skv, int group) {
  return BH <= 0 || Sq <= 0 || Skv <= 0 || group <= 0 || BH % group != 0 || BH > 65535 ||
         (Sq + BQ - 1) / BQ > 65535;
}

}  // namespace

// head_dim is q's and k's, head_dim_v v's and o's; window <= 0 means no
// sliding window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int Sq, int Skv, int head_dim, int head_dim_v,
                                      int group, int causal, int window, float scale,
                                      void* stream) {
  if (bad_shape(BH, Sq, Skv, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(QK, V)                                                                \
  if (head_dim == QK && head_dim_v == V)                                                 \
    return launch<QK, V, false>(q, k, v, o, nullptr, BH, Sq, Skv, group, causal, window,  \
                                scale, s);
  FLASH_CASE(16, 16)
  FLASH_CASE(64, 64)
  FLASH_CASE(120, 120)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(24, 16)  // MiniCPM3 smoke's MLA: q/k 16 + 8 (padded to 32), v 16
  FLASH_CASE(96, 64)  // MiniCPM3's MLA: q/k 64 + 32, v 64
  FLASH_CASE(192, 128)  // DeepSeek-V2's MLA: q/k 128 + 64, v 128
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The training forward: o as above and lse [BH, Sq] fp32, natural log, at
// every pair above.
extern "C" int flash_attention_lse_launch(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int BH, int Sq, int Skv, int head_dim,
                                          int head_dim_v, int group, int causal, int window,
                                          float scale, void* stream) {
  if (bad_shape(BH, Sq, Skv, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FLASH_LSE_CASE(QK, V)                                                           \
  if (head_dim == QK && head_dim_v == V)                                                \
    return launch<QK, V, true>(q, k, v, o, l, BH, Sq, Skv, group, causal, window, scale, s);
  FLASH_LSE_CASE(16, 16)
  FLASH_LSE_CASE(64, 64)
  FLASH_LSE_CASE(120, 120)
  FLASH_LSE_CASE(128, 128)
  FLASH_LSE_CASE(256, 256)
  FLASH_LSE_CASE(24, 16)
  FLASH_LSE_CASE(96, 64)
  FLASH_LSE_CASE(192, 128)
#undef FLASH_LSE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
