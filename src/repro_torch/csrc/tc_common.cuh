// Tensor-core building blocks shared by the bf16 kernels of
// flash_attention.cu and paged_attention.cu (sm_90a): cp.async copies into
// shared memory, ldmatrix loads, mma.sync.m16n8k16 (bf16 in, float32
// accumulate) and the XOR swizzle of bf16 tiles that keeps an ldmatrix or a
// cp.async phase on 8 distinct 16-byte bank groups. Tiles are rows of HD
// bf16 (HD a multiple of 16 whose chunk count is a power of two).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of (row, 16-byte chunk) in a tile of rows of HD bf16. The
// chunk index is XORed with the row (by pairs of rows at hd 32, whose rows
// are 64 bytes), so the 8 rows of one ldmatrix phase, or the 8 chunks of
// one cp.async phase, land in 8 distinct 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CH = HD / 8;
  constexpr int RPL = CH >= 8 ? 1 : 8 / CH;   // rows per 128-byte line
  constexpr int W = CH >= 8 ? 8 : CH;
  return row * HD + ((chunk ^ ((row / RPL) % W)) << 3);
}

// A fragment of k-step kk (columns 16 kk ..) of rows [m0, m0 + 16) of a tile
template <int HD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t tile,
                                       int m0, int kk, int lane) {
  ldsm_x4(a, tile + 2 * swz<HD>(m0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// acc (16 x N) += A (16 x HD) B^T, B = rows [0, N) of a tile [n][HD] (both
// operands HD-major, as S = Q K^T). A is rows [m0, m0 + 16) of a_tile, or
// its fragments af held in registers when AREG.
template <int HD, int N, bool AREG>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const uint32_t (&af)[AREG ? HD / 16 : 1][4],
                                        uint32_t a_tile, int m0, uint32_t tile,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    if constexpr (AREG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[kk][i];
    } else {
      ldsm_a<HD>(a, a_tile, m0, kk, lane);
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, tile + 2 * swz<HD>(16 * j + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
      mma16816(acc[2 * j], a, b[0], b[1]);
      mma16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x N) += A (16 x KD) B, B = rows [0, KD), columns [n0, n0 + N) of
// a tile [k][HD], read transposed (as P V); A in registers
template <int HD, int KD, int N>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 8][4],
                                       const uint32_t (&a)[KD / 16][4],
                                       uint32_t tile, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + 2 * swz<HD>(16 * kk + (lane & 7) +
                                          (((lane >> 3) & 1) << 3),
                                      (n0 >> 3) + 2 * j + (lane >> 4)));
      mma16816(acc[2 * j], a[kk], b[0], b[1]);
      mma16816(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
}

// an accumulator (16 x N) rounded to bf16 as the A operand of the next
// product: m16n8k16's accumulator layout is its A layout
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// registers, local bytes (spills and stack) and the given dynamic shared
// memory of a kernel, for the libraries' *_tc_info exports
template <typename KernelT>
int info(KernelT kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  if (int rc = static_cast<int>(cudaFuncGetAttributes(&a, kernel))) return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem);
  return 0;
}

}  // namespace tc
}  // namespace
