// Paged attention kernels of the fused serving step, for Hopper (sm_90a).
//
// 1) aqua_mixed_attention replaces paged_mixed_attention_pool
//    (_mixed_pool_kernel) in src/repro/kernels/paged_attention/kernel.py:
//    one launch of online-softmax attention for the decode lanes AND the
//    prefill chunk rows of a packed step, over the page-major pool
//    (P, 2, K, page, hd) reached through per-row block tables.
//
//    Bound: at the serving shapes (one query token per decode lane, chunk
//    rows of a few hundred tokens, 16-token pages) the work per byte of K/V
//    is small, so the least time is set by the bytes of the pages the rows
//    reference; the arithmetic is 4 * rows * keys * hd operations.
//    Design: one block per (packed row r, kv head h, tile of 32 of the
//    row's Tc * G query rows). The block walks the row's pages IN ORDER
//    (i = 0 .. read_pps-1), loading block_tables[r, i] itself (the TPU's
//    scalar prefetch), stages that page's K and V for head h in shared
//    memory as float once, and serves all 32 query rows from it, so a page
//    is read from device memory once per tile instead of once per query
//    row. Each warp owns 4 query rows and keeps their running max m, sum l
//    and output accumulator in float registers; within a page, lane j
//    scores key j, the warp reduces max and sum with shuffles, and each
//    lane accumulates output dims lane, lane + 32, ... A query row's
//    reduction order depends only on its own row's pages, never on what
//    else rides the launch or on the tiling. Masking follows the reference
//    exactly: key k_pos attends when k_pos <= q_start + (decode ? 0 : t),
//    and for decode lanes only when t < n_real; masked keys score the
//    finite NEG_INF = -1e30 (a fully masked row becomes the uniform mean
//    over every swept page, never NaN), and the final division uses
//    l == 0 -> 1. Pool offsets are computed in 64 bits. A tile whose rows
//    are all live (chunk rows, bucket-pad rows included, and a decode
//    lane's real token) stops after the last page any of them needs: the
//    pages past it would add exactly 0 to every row, so the result is
//    bit-identical. A tile holding a decode lane's fully masked tail rows
//    sweeps all read_pps pages, as the reference does; those rows share one
//    trajectory, so a warp computes one and copies it, and their keys are
//    never scored. wgmma/TMA tiling is later work.
//
// 2) aqua_append_kv replaces append_kv (_append_kernel): one block per
//    decode lane writes that token's K and V rows in place at
//    pool[slots[b], 0|1, :, offsets[b], :]. Bound: bytes (2 * B * K * hd
//    elements written); the TPU's input-output aliasing becomes a plain
//    in-place store. Idle lanes all target the scratch page at offset 0
//    with identical data, a benign race.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxHd = 128;
constexpr int kHdRegs = kMaxHd / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mixed_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_starts,
                       const int* __restrict__ n_reals,
                       const int* __restrict__ is_decode, T* __restrict__ out,
                       int Tc, int H, int K, int page, int hd, int read_pps,
                       int bt_stride, long long n_pool, float scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  const int n_rows = Tc * G;
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nc = hd / 32;
  float* q_s = smem;                               // kRowsPerBlock x hd
  float* k_s = q_s + kRowsPerBlock * hd;           // page x (hd + 1)
  float* v_s = k_s + page * (hd + 1);              // page x hd

  const int q_start = q_starts[r];
  const int n_real = n_reals[r];
  const bool dec = is_decode[r] != 0;

  for (int e = threadIdx.x; e < kRowsPerBlock * hd; e += blockDim.x) {
    const int row = row0 + e / hd;
    float val = 0.f;
    if (row < n_rows) {
      const int t = row / G, g = row % G;
      val = to_float(q[((static_cast<long long>(r) * Tc + t) * H + h * G + g)
                           * hd + e % hd]);
    }
    q_s[e] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kHdRegs];
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) {
    m[w] = kNegInf;
    l[w] = 0.f;
#pragma unroll
    for (int c = 0; c < kHdRegs; ++c) acc[w][c] = 0.f;
  }

  // Pages this tile must sweep. A live query row (a chunk row, or a
  // decode lane's real token) always has key 0 unmasked, so its running
  // max is finite from the first page on and every fully masked page after
  // its last needed one adds exactly 0 to l and acc (p = exp(-1e30 - m) is
  // 0, alpha is 1): a tile of live rows stops after the last page any of
  // them needs, bit-identically. A dead row (a decode lane's tail,
  // t >= n_real) is fully masked and must sweep every page.
  bool any_live = false, any_dead = false;
  int max_q_pos = 0;
  for (int local = 0; local < kRowsPerBlock; ++local) {
    const int row = row0 + local;
    if (row >= n_rows) break;
    const int t = row / G;
    if (!dec || t < n_real) {
      any_live = true;
      max_q_pos = max(max_q_pos, q_start + (dec ? 0 : t));
    } else {
      any_dead = true;
    }
  }
  const int n_pages =
      any_dead ? read_pps : min(read_pps, max_q_pos / page + 1);

  const long long page_elems = static_cast<long long>(page) * hd;
  for (int i = 0; i < n_pages; ++i) {
    const long long slot =
        block_tables[static_cast<long long>(r) * bt_stride + i];
    const bool ok = slot >= 0 && slot < n_pool;
    const long long kb = ((slot * 2 + 0) * K + h) * page_elems;
    const long long vb = ((slot * 2 + 1) * K + h) * page_elems;
    __syncthreads();                    // previous page fully consumed
    for (int e = threadIdx.x; e < page_elems; e += blockDim.x) {
      if (any_live) {
        const int j = e / hd, d = e % hd;
        k_s[j * (hd + 1) + d] = ok ? to_float(pool[kb + e]) : 0.f;
      }
      v_s[e] = ok ? to_float(pool[vb + e]) : 0.f;
    }
    __syncthreads();
    // dead rows share one trajectory (every key masked): a warp computes
    // its first dead row and copies it to the others at the end
    bool dead_seen = false;
#pragma unroll
    for (int w = 0; w < kRowsPerWarp; ++w) {
      const int local = warp * kRowsPerWarp + w;
      const int row = row0 + local;
      if (row >= n_rows) continue;      // warp-uniform
      const int t = row / G;
      const int q_pos = q_start + (dec ? 0 : t);
      const bool live = !dec || t < n_real;
      if (!live && dead_seen) continue;
      dead_seen |= !live;
      const float* qr = q_s + local * hd;
      for (int j0 = 0; j0 < page; j0 += 32) {
        const int j = j0 + lane;
        const bool key = j < page;
        float s = -CUDART_INF_F;        // lanes past the page: no key
        if (key) {
          s = kNegInf;
          if (live && i * page + j <= q_pos) {
            const float* kr = k_s + j * (hd + 1);
            float dot = 0.f;
            for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
            s = dot * scale;
          }
        }
        const float m_new = fmaxf(m[w], warp_max(s));
        const float p = key ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[w] - m_new);
        l[w] = alpha * l[w] + warp_sum(p);
#pragma unroll
        for (int c = 0; c < kHdRegs; ++c) acc[w][c] *= alpha;
        const int nk = min(32, page - j0);
        for (int jj = 0; jj < nk; ++jj) {
          const float pj = __shfl_sync(kFull, p, jj);
          const float* vr = v_s + (j0 + jj) * hd;
#pragma unroll
          for (int c = 0; c < kHdRegs; ++c)
            if (c < nc) acc[w][c] += pj * vr[lane + 32 * c];
        }
        m[w] = m_new;
      }
    }
  }

  bool have_dead = false;
  float dead_l = 0.f, dead_acc[kHdRegs];
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) {
    const int row = row0 + warp * kRowsPerWarp + w;
    if (row >= n_rows) continue;
    const int t = row / G, g = row % G;
    float lw = l[w];
    float a[kHdRegs];
#pragma unroll
    for (int c = 0; c < kHdRegs; ++c) a[c] = acc[w][c];
    if (dec && t >= n_real) {
      if (!have_dead) {
        have_dead = true;
        dead_l = lw;
#pragma unroll
        for (int c = 0; c < kHdRegs; ++c) dead_acc[c] = a[c];
      } else {
        lw = dead_l;
#pragma unroll
        for (int c = 0; c < kHdRegs; ++c) a[c] = dead_acc[c];
      }
    }
    const float denom = lw == 0.f ? 1.f : lw;
    const long long ob =
        ((static_cast<long long>(r) * Tc + t) * H + h * G + g) * hd;
#pragma unroll
    for (int c = 0; c < kHdRegs; ++c)
      if (c < nc) out[ob + lane + 32 * c] = from_float<T>(a[c] / denom);
  }
}

template <typename T>
int launch_mixed(const void* q, const void* pool, const int* bt,
                 const int* q_starts, const int* n_reals, const int* is_dec,
                 void* out, int R, int Tc, int H, int K, int page, int hd,
                 int read_pps, int bt_stride, long long n_pool, float scale,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRowsPerBlock) * hd
                       + static_cast<size_t>(page) * (hd + 1)
                       + static_cast<size_t>(page) * hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mixed_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_rows = Tc * (H / K);
  dim3 grid(R, K, (n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  mixed_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), bt, q_starts,
      n_reals, is_dec, static_cast<T*>(out), Tc, H, K, page, hd, read_pps,
      bt_stride, n_pool, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
__global__ void __launch_bounds__(256)
append_kv_kernel(E* __restrict__ pool, const E* __restrict__ k_new,
                 const E* __restrict__ v_new, const int* __restrict__ slots,
                 const int* __restrict__ offsets, int K, int page, int hd,
                 long long n_pool) {
  const int b = blockIdx.x;
  const long long slot = slots[b];
  const int off = offsets[b];
  if (slot < 0 || slot >= n_pool || off < 0 || off >= page) return;
  const int n = K * hd;
  const long long page_elems = static_cast<long long>(page) * hd;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int h = e / hd, d = e % hd;
    const long long row = static_cast<long long>(off) * hd + d;
    pool[((slot * 2 + 0) * K + h) * page_elems + row] =
        k_new[static_cast<long long>(b) * n + e];
    pool[((slot * 2 + 1) * K + h) * page_elems + row] =
        v_new[static_cast<long long>(b) * n + e];
  }
}

template <typename E>
int launch_append(void* pool, const void* k, const void* v, const int* slots,
                  const int* offsets, int B, int K, int page, int hd,
                  long long n_pool, cudaStream_t stream) {
  append_kv_kernel<E><<<B, 256, 0, stream>>>(
      static_cast<E*>(pool), static_cast<const E*>(k),
      static_cast<const E*>(v), slots, offsets, K, page, hd, n_pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int aqua_mixed_attention(const void* q, const void* pool,
                                    const int* block_tables,
                                    const int* q_starts, const int* n_reals,
                                    const int* is_decode, void* out, int R,
                                    int Tc, int H, int K, int page, int hd,
                                    int read_pps, int bt_stride,
                                    long long n_pool, float scale, int dtype,
                                    void* stream) {
  if (hd % 32 != 0 || hd > kMaxHd || K <= 0 || H % K != 0) return -1;
  if (R == 0 || Tc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mixed<float>(q, pool, block_tables, q_starts, n_reals,
                               is_decode, out, R, Tc, H, K, page, hd, read_pps,
                               bt_stride, n_pool, scale, s);
  if (dtype == 1)
    return launch_mixed<__nv_bfloat16>(q, pool, block_tables, q_starts,
                                       n_reals, is_decode, out, R, Tc, H, K,
                                       page, hd, read_pps, bt_stride, n_pool,
                                       scale, s);
  return -1;
}

extern "C" int aqua_append_kv(void* pool, const void* k_new, const void* v_new,
                              const int* slots, const int* offsets, int B,
                              int K, int page, int hd, long long n_pool,
                              int elem_bytes, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch_append<uint16_t>(pool, k_new, v_new, slots, offsets, B, K,
                                   page, hd, n_pool, s);
  if (elem_bytes == 4)
    return launch_append<uint32_t>(pool, k_new, v_new, slots, offsets, B, K,
                                   page, hd, n_pool, s);
  return -1;
}
