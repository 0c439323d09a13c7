// Block regroup of the full-lane alltoall for Hopper (sm_90a):
// out[i, o] = x[o, i] for x [No, Ni, blk, d], out [Ni, No, blk, d].
//
// Replaces the TPU kernel `a2a_pack_kernel` / `a2a_pack_pallas` of
// src/repro/kernels/a2a_pack.py, whose grid steps over the (No, Ni) tiles
// in order and copies one (blk, d) tile through VMEM per step.  Here the
// tiles are independent byte ranges: tile t = o * Ni + i starts at byte
// t * tile_bytes of x and goes to byte (i * No + o) * tile_bytes of out.
// The copy never looks at the values, so one kernel serves every dtype.
//
// Bound on the H100: bytes (each byte read once and written once, no
// arithmetic).  The design only tries to move them in wide, coalesced
// transactions: the grid is (chunks of a tile, tiles); each CTA copies one
// chunk of kChunk 16-byte vectors of one tile, each thread kUnroll vectors
// kThreads apart, all loads issued before the stores.  A tile whose source
// and destination both start on a 16-byte boundary goes by vectors, and
// its last tile_bytes % 16 bytes by the byte loop that follows; a tile that
// does not (a tile size that is not a multiple of 16, or an unaligned
// pointer) goes by that byte loop alone, in the same kernel.
//
// C interface (ctypes): every function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // vectors in flight per thread
constexpr long long kChunk = kThreads * kUnroll;  // vectors per CTA
constexpr long long kMaxTilesInGrid = 65535;  // gridDim.y limit

// No * Ni < 2^31 (the launcher checks): the tile index and its (o, i) are
// 32-bit, which keeps the division in registers.
__global__ void __launch_bounds__(kThreads)
a2a_pack_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int No, int Ni,
                long long tile_bytes) {
  const int ntiles = No * Ni;
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int o = t / Ni, i = t % Ni;
    const uint8_t* src = x + t * tile_bytes;
    uint8_t* dst = out + (i * No + o) * tile_bytes;
    const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
    const long long nvec = vec ? tile_bytes / 16 : 0;

    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    const long long chunk0 = (long long)blockIdx.x * kChunk;
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = chunk0 + u * kThreads + threadIdx.x;
      if (v < nvec) r[u] = src4[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = chunk0 + u * kThreads + threadIdx.x;
      if (v < nvec) dst4[v] = r[u];
    }

    // the bytes past the vectors: the tail of an aligned tile, or all of an
    // unaligned one, strided over every thread that works on this tile
    for (long long b = nvec * 16 + (long long)blockIdx.x * kThreads + threadIdx.x;
         b < tile_bytes; b += (long long)gridDim.x * kThreads)
      dst[b] = src[b];
  }
}

}  // namespace

extern "C" int a2a_pack_launch(const void* x, void* out, long long No, long long Ni,
                               long long tile_bytes, void* stream) {
  if (No <= 0 || Ni <= 0 || tile_bytes <= 0 || No * Ni > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // enough chunks for a tile's vectors; an unaligned tile's byte loop
  // strides over the same threads
  const long long chunks = ((tile_bytes + 15) / 16 + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long ntiles = No * Ni;
  dim3 grid((unsigned)chunks, (unsigned)(ntiles < kMaxTilesInGrid ? ntiles : kMaxTilesInGrid));
  a2a_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), (int)No, (int)Ni, tile_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* a2a_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
