// Paged attention kernels of the serving paths, for Hopper (sm_90a).
//
// Four attention kernels replace the four attention entry points of
// src/repro/kernels/paged_attention/kernel.py:
//
// 1) aqua_mixed_attention replaces paged_mixed_attention_pool
//    (_mixed_pool_kernel): one launch for the decode lanes AND the prefill
//    chunk rows of a packed engine step over the page-major pool
//    (P, 2, K, page, hd) reached through per-row block tables.
// 2) aqua_prefill_attention_pool replaces paged_prefill_attention_pool
//    (_chunk_pool_kernel): one request's chunk of Tc query tokens at
//    q_start + t attends causally to every page written so far; keys at
//    k_pos <= q_start + t for EVERY row, bucket padding included.
// 3) aqua_decode_attention_pool replaces paged_attention_pool
//    (_paged_pool_kernel): one query token per sequence over the same
//    pool; keys at k_pos < lengths[b].
// 4) aqua_paged_attention replaces paged_attention (_paged_kernel): the
//    same decode over SPLIT K and V pools (K, P, page, hd), any strides over
//    (K, P) with each page's (page, hd) block contiguous, so the split
//    halves of the fused pool are read in place.
//
// Bound: at the serving shapes (one query token per decode lane, chunks of
// a few hundred tokens, 16-token pages) the work per byte of K/V is small,
// so the least time is set by the bytes of the pages the rows reference;
// the arithmetic is 4 * query rows * keys * hd operations.
//
// Design, shared by all four: a block owns (sequence or packed row, kv
// head h, tile of up to 32 query rows) and walks that sequence's pages IN
// ORDER, loading its block-table entries itself (the TPU's scalar
// prefetch). Each page's K and V for head h are staged in shared memory as
// float once and serve every query row of the tile. The per-row step is
// ONE __device__ function (row_page_step) called by every kernel: lane j
// scores key j, the warp reduces max and sum with shuffles, each lane
// accumulates output dims lane, lane + 32, ... Every floating-point
// operation of the step is an explicit round-to-nearest intrinsic
// (__fmaf_rn, __fmul_rn, __fsub_rn, __fdiv_rn), so the compiler cannot
// contract or reorder it differently in different kernels: a query row's
// result depends only on its own pages, never on the kernel or on what else
// rides the launch. So the per-request kernels agree with the fused mixed
// kernel bit for bit, the property the reference's design promises.
// Masked keys score the finite NEG_INF = -1e30 (a fully masked row becomes
// the uniform mean over every swept page, never NaN); the final division
// uses l == 0 -> 1. Pool offsets are computed in 64 bits. A tile whose
// rows are all live (each has key 0 unmasked, so its running max is finite
// from the first page on) stops after the last page any row needs: the
// pages past it would add exactly 0 to every row, so the result is
// bit-identical to the full sweep. A tile holding a fully masked row (a
// decode lane's tail rows in the mixed kernel, a sequence with
// lengths == 0 in the decode kernels) sweeps every page, as the reference
// does. wgmma/TMA tiling, several pages per iteration and split-K decode
// are later work (split-K would change the reduction order of the decode
// kernels and the mixed kernel's decode lanes together, or break their
// bit-identity).
//
// 5) aqua_append_kv replaces append_kv (_append_kernel): one block per
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
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Pool layouts: element offsets of the (page, hd) block of K and of V for
// (slot, kv head). The page load is written once against this interface.
struct FusedPool {            // one tensor (P, 2, K, page, hd)
  long long n_slots;
  int K;
  long long page_elems;
  __device__ long long k_off(long long slot, int h) const {
    return ((slot * 2 + 0) * K + h) * page_elems;
  }
  __device__ long long v_off(long long slot, int h) const {
    return ((slot * 2 + 1) * K + h) * page_elems;
  }
};

struct SplitPools {           // K and V each (K, P, page, hd), strided
  long long n_slots;
  long long head_stride, slot_stride;
  __device__ long long k_off(long long slot, int h) const {
    return h * head_stride + slot * slot_stride;
  }
  __device__ long long v_off(long long slot, int h) const {
    return k_off(slot, h);
  }
};

// Stage page `slot` of head h as float: K row j at k_s[j * (hd + 1)] (the
// pad keeps lane j's row reads off one bank), V row j at v_s[j * hd]. An
// out-of-pool slot reads as zeros. Callers synchronise around it.
template <typename T, typename Layout>
__device__ __forceinline__ void stage_page(const T* __restrict__ k_base,
                                           const T* __restrict__ v_base,
                                           const Layout& lay, long long slot,
                                           int h, int page, int hd,
                                           bool load_k, float* k_s,
                                           float* v_s) {
  const bool ok = slot >= 0 && slot < lay.n_slots;
  const long long kb = ok ? lay.k_off(slot, h) : 0;
  const long long vb = ok ? lay.v_off(slot, h) : 0;
  const int n = page * hd;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    if (load_k) {
      const int j = e / hd, d = e % hd;
      k_s[j * (hd + 1) + d] = ok ? to_float(k_base[kb + e]) : 0.f;
    }
    v_s[e] = ok ? to_float(v_base[vb + e]) : 0.f;
  }
}

// Online-softmax state of one query row, held by one warp.
struct RowState {
  float m, l, acc[kHdRegs];
};

__device__ __forceinline__ void row_init(RowState& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int c = 0; c < kHdRegs; ++c) st.acc[c] = 0.f;
}

// The per-query-row page step every kernel runs: keys k0 .. k0 + page - 1
// of the staged page; a key attends when the row is live and its position
// is <= q_pos. Called by the whole warp.
__device__ __forceinline__ void row_page_step(RowState& st,
                                              const float* __restrict__ qr,
                                              const float* __restrict__ k_s,
                                              const float* __restrict__ v_s,
                                              int page, int hd, int k0,
                                              int q_pos, bool live,
                                              float scale, int lane) {
  const int nc = hd / 32;
  for (int j0 = 0; j0 < page; j0 += 32) {
    const int j = j0 + lane;
    const bool key = j < page;
    float s = -CUDART_INF_F;            // lanes past the page: no key
    if (key) {
      s = kNegInf;
      if (live && k0 + j <= q_pos) {
        const float* kr = k_s + j * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = __fmaf_rn(qr[d], kr[d], dot);
        s = __fmul_rn(dot, scale);
      }
    }
    const float m_new = fmaxf(st.m, warp_max(s));
    const float p = key ? expf(__fsub_rn(s, m_new)) : 0.f;
    const float alpha = expf(__fsub_rn(st.m, m_new));
    st.l = __fmaf_rn(alpha, st.l, warp_sum(p));
#pragma unroll
    for (int c = 0; c < kHdRegs; ++c) st.acc[c] = __fmul_rn(st.acc[c], alpha);
    const int nk = min(32, page - j0);
    for (int jj = 0; jj < nk; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj);
      const float* vr = v_s + (j0 + jj) * hd;
#pragma unroll
      for (int c = 0; c < kHdRegs; ++c)
        if (c < nc) st.acc[c] = __fmaf_rn(pj, vr[lane + 32 * c], st.acc[c]);
    }
    st.m = m_new;
  }
}

template <typename T>
__device__ __forceinline__ void row_store(const RowState& st, T* out, int hd,
                                          int lane) {
  const float denom = st.l == 0.f ? 1.f : st.l;
#pragma unroll
  for (int c = 0; c < kHdRegs; ++c)
    if (c < hd / 32) out[lane + 32 * c] = from_float<T>(__fdiv_rn(st.acc[c],
                                                                  denom));
}

// Shared memory of one block: the tile's query rows, one page of K (row
// padded to hd + 1) and one page of V, all float.
size_t attention_smem(int page, int hd) {
  return sizeof(float) * (static_cast<size_t>(kRowsPerBlock) * hd
                          + static_cast<size_t>(page) * (hd + 1)
                          + static_cast<size_t>(page) * hd);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mixed_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                       FusedPool lay, const int* __restrict__ block_tables,
                       const int* __restrict__ q_starts,
                       const int* __restrict__ n_reals,
                       const int* __restrict__ is_decode, T* __restrict__ out,
                       int Tc, int H, int K, int page, int hd, int read_pps,
                       int bt_stride, float scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  const int n_rows = Tc * G;
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) row_init(st[w]);

  // Pages this tile must sweep: a tile of live rows (chunk rows, or a
  // decode lane's real token) stops after the last page any of them needs;
  // a dead row (a decode lane's tail, t >= n_real) is fully masked and
  // must sweep every page.
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

  for (int i = 0; i < n_pages; ++i) {
    const long long slot =
        block_tables[static_cast<long long>(r) * bt_stride + i];
    __syncthreads();                    // previous page fully consumed
    stage_page(pool, pool, lay, slot, h, page, hd, any_live, k_s, v_s);
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
      const bool live = !dec || t < n_real;
      if (!live && dead_seen) continue;
      dead_seen |= !live;
      row_page_step(st[w], q_s + local * hd, k_s, v_s, page, hd, i * page,
                    q_start + (dec ? 0 : t), live, scale, lane);
    }
  }

  int first_dead = -1;
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) {
    const int row = row0 + warp * kRowsPerWarp + w;
    if (row >= n_rows) continue;
    const int t = row / G, g = row % G;
    int src = w;
    if (dec && t >= n_real) {
      if (first_dead < 0) first_dead = w;
      src = first_dead;
    }
    RowState s = st[0];
#pragma unroll
    for (int u = 1; u < kRowsPerWarp; ++u)
      if (u == src) s = st[u];
    row_store(s, out + ((static_cast<long long>(r) * Tc + t) * H + h * G + g)
                           * hd, hd, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                         FusedPool lay, const int* __restrict__ block_tables,
                         const int* __restrict__ q_starts, T* __restrict__ out,
                         int Tc, int H, int K, int page, int hd, int read_pps,
                         int bt_stride, float scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  const int n_rows = Tc * G;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_s = smem;
  float* k_s = q_s + kRowsPerBlock * hd;
  float* v_s = k_s + page * (hd + 1);
  const int q_start = q_starts[b];

  for (int e = threadIdx.x; e < kRowsPerBlock * hd; e += blockDim.x) {
    const int row = row0 + e / hd;
    float val = 0.f;
    if (row < n_rows) {
      const int t = row / G, g = row % G;
      val = to_float(q[((static_cast<long long>(b) * Tc + t) * H + h * G + g)
                           * hd + e % hd]);
    }
    q_s[e] = val;
  }
  RowState st[kRowsPerWarp];
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) row_init(st[w]);

  // every row is live (row t attends to k_pos <= q_start + t): the tile
  // stops after the page of its last row's position
  const int last_row = min(n_rows, row0 + kRowsPerBlock) - 1;
  const int n_pages = min(read_pps, (q_start + last_row / G) / page + 1);

  for (int i = 0; i < n_pages; ++i) {
    const long long slot =
        block_tables[static_cast<long long>(b) * bt_stride + i];
    __syncthreads();
    stage_page(pool, pool, lay, slot, h, page, hd, true, k_s, v_s);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kRowsPerWarp; ++w) {
      const int local = warp * kRowsPerWarp + w;
      const int row = row0 + local;
      if (row >= n_rows) continue;      // warp-uniform
      row_page_step(st[w], q_s + local * hd, k_s, v_s, page, hd, i * page,
                    q_start + row / G, true, scale, lane);
    }
  }
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) {
    const int row = row0 + warp * kRowsPerWarp + w;
    if (row >= n_rows) continue;
    const int t = row / G, g = row % G;
    row_store(st[w], out + ((static_cast<long long>(b) * Tc + t) * H + h * G
                            + g) * hd, hd, lane);
  }
}

// Decode over either pool layout: one block per (sequence b, kv head h,
// tile of the group's G query heads), the heads on warps.
template <typename T, typename Layout>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_base,
                        const T* __restrict__ v_base, Layout lay,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int K, int page, int hd, int pps,
                        int bt_stride, float scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_s = smem;
  float* k_s = q_s + kRowsPerBlock * hd;
  float* v_s = k_s + page * (hd + 1);

  for (int e = threadIdx.x; e < kRowsPerBlock * hd; e += blockDim.x) {
    const int g = row0 + e / hd;
    q_s[e] = g < G ? to_float(q[(static_cast<long long>(b) * H + h * G + g)
                                    * hd + e % hd])
                   : 0.f;
  }
  RowState st[kRowsPerWarp];
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) row_init(st[w]);

  // keys at k_pos < length, i.e. k_pos <= length - 1; length 0 leaves the
  // row fully masked, and it must sweep every page (the uniform mean)
  const int length = lengths[b];
  const bool live = length >= 1;
  const int q_pos = length - 1;
  const int n_pages = live ? min(pps, q_pos / page + 1) : pps;

  for (int i = 0; i < n_pages; ++i) {
    const long long slot =
        block_tables[static_cast<long long>(b) * bt_stride + i];
    __syncthreads();
    stage_page(k_base, v_base, lay, slot, h, page, hd, live, k_s, v_s);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kRowsPerWarp; ++w) {
      const int local = warp * kRowsPerWarp + w;
      if (row0 + local >= G) continue;  // warp-uniform
      row_page_step(st[w], q_s + local * hd, k_s, v_s, page, hd, i * page,
                    q_pos, live, scale, lane);
    }
  }
#pragma unroll
  for (int w = 0; w < kRowsPerWarp; ++w) {
    const int g = row0 + warp * kRowsPerWarp + w;
    if (g >= G) continue;
    row_store(st[w], out + (static_cast<long long>(b) * H + h * G + g) * hd,
              hd, lane);
  }
}

bool bad_heads(int H, int K, int hd) {
  return hd % 32 != 0 || hd > kMaxHd || hd <= 0 || K <= 0 || H % K != 0;
}

template <typename T>
int launch_mixed(const void* q, const void* pool, const int* bt,
                 const int* q_starts, const int* n_reals, const int* is_dec,
                 void* out, int R, int Tc, int H, int K, int page, int hd,
                 int read_pps, int bt_stride, long long n_pool, float scale,
                 cudaStream_t stream) {
  const size_t smem = attention_smem(page, hd);
  if (int e = set_smem(mixed_attention_kernel<T>, smem)) return e;
  const int n_rows = Tc * (H / K);
  dim3 grid(R, K, (n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const FusedPool lay{n_pool, K, static_cast<long long>(page) * hd};
  mixed_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), lay, bt,
      q_starts, n_reals, is_dec, static_cast<T*>(out), Tc, H, K, page, hd,
      read_pps, bt_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prefill(const void* q, const void* pool, const int* bt,
                   const int* q_starts, void* out, int B, int Tc, int H,
                   int K, int page, int hd, int read_pps, int bt_stride,
                   long long n_pool, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem(page, hd);
  if (int e = set_smem(prefill_attention_kernel<T>, smem)) return e;
  const int n_rows = Tc * (H / K);
  dim3 grid(B, K, (n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const FusedPool lay{n_pool, K, static_cast<long long>(page) * hd};
  prefill_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), lay, bt,
      q_starts, static_cast<T*>(out), Tc, H, K, page, hd, read_pps,
      bt_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Layout>
int launch_decode(const void* q, const void* k, const void* v,
                  const Layout& lay, const int* bt, const int* lengths,
                  void* out, int B, int H, int K, int page, int hd, int pps,
                  int bt_stride, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem(page, hd);
  if (int e = set_smem(decode_attention_kernel<T, Layout>, smem)) return e;
  const int G = H / K;
  dim3 grid(B, K, (G + kRowsPerBlock - 1) / kRowsPerBlock);
  decode_attention_kernel<T, Layout><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lay, bt, lengths, static_cast<T*>(out), H, K,
      page, hd, pps, bt_stride, scale);
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
  if (bad_heads(H, K, hd)) return -1;
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

extern "C" int aqua_prefill_attention_pool(const void* q, const void* pool,
                                           const int* block_tables,
                                           const int* q_starts, void* out,
                                           int B, int Tc, int H, int K,
                                           int page, int hd, int read_pps,
                                           int bt_stride, long long n_pool,
                                           float scale, int dtype,
                                           void* stream) {
  if (bad_heads(H, K, hd)) return -1;
  if (B == 0 || Tc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prefill<float>(q, pool, block_tables, q_starts, out, B, Tc,
                                 H, K, page, hd, read_pps, bt_stride, n_pool,
                                 scale, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(q, pool, block_tables, q_starts, out,
                                         B, Tc, H, K, page, hd, read_pps,
                                         bt_stride, n_pool, scale, s);
  return -1;
}

extern "C" int aqua_decode_attention_pool(const void* q, const void* pool,
                                          const int* block_tables,
                                          const int* lengths, void* out,
                                          int B, int H, int K, int page,
                                          int hd, int pps, int bt_stride,
                                          long long n_pool, float scale,
                                          int dtype, void* stream) {
  if (bad_heads(H, K, hd)) return -1;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FusedPool lay{n_pool, K, static_cast<long long>(page) * hd};
  if (dtype == 0)
    return launch_decode<float>(q, pool, pool, lay, block_tables, lengths,
                                out, B, H, K, page, hd, pps, bt_stride, scale,
                                s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, pool, pool, lay, block_tables,
                                        lengths, out, B, H, K, page, hd, pps,
                                        bt_stride, scale, s);
  return -1;
}

// head_stride / slot_stride: element strides of K (and V, which must share
// them) along their kv-head and page-slot axes.
extern "C" int aqua_paged_attention(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const int* block_tables,
                                    const int* lengths, void* out, int B,
                                    int H, int K, int page, int hd, int pps,
                                    int bt_stride, long long head_stride,
                                    long long slot_stride, long long n_pool,
                                    float scale, int dtype, void* stream) {
  if (bad_heads(H, K, hd)) return -1;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SplitPools lay{n_pool, head_stride, slot_stride};
  if (dtype == 0)
    return launch_decode<float>(q, k_pages, v_pages, lay, block_tables,
                                lengths, out, B, H, K, page, hd, pps,
                                bt_stride, scale, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pages, v_pages, lay,
                                        block_tables, lengths, out, B, H, K,
                                        page, hd, pps, bt_stride, scale, s);
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
