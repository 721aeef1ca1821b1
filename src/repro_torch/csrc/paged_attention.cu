// Paged attention kernels of the serving paths, for Hopper (sm_90a).
//
// Four attention entry points replace the four attention kernels of
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
// a few hundred tokens, 16-token pages, hd 64) the work per byte of K/V is
// small: the least time is the bytes of the pages the unmasked keys live
// on, 2-6 us, under a launch's latency; the arithmetic, 4 * query rows *
// keys * hd operations, is ~1.2 GFLOP for a mixed step. So the design is
// about latency and parallelism: many warps in flight, loads issued
// together, no barrier per page, no work on rows nobody reads.
//
// bfloat16 (the serving path): two device paths, each one __device__
// routine that every kernel calling it shares (namespace tc).
//  - The decode path (decode_pass), for entry points 3) and 4) and the mixed
//    kernel's decode lanes: a block of 8 warps per (sequence, kv head);
//    page i goes to warp i % 8, each warp keeping its own (m, l, acc) for
//    up to 4 query heads of the group. A warp reads its pages' K and V as
//    bf16 straight from the pool, 16 bytes a lane (lane = key kk of a load
//    x 16-byte chunk c of the row: a page's (page, hd) block for one head
//    is contiguous), every load of a step in flight at once; a key's score
//    is a tree over the lane's 8 dims and then over the row's lanes, no
//    dependent chain. The warps' states combine in warp order through
//    shared memory. The page loop stops at the page holding the row's last
//    key; a warp with only masked keys (or none) holds m = -1e30 and is
//    scaled by exp(-1e30 - M) = 0 exactly, so the cut equals the full
//    sweep bit for bit, and lengths == 0 (M = -1e30, every scale 1) gives
//    the uniform mean over every page of the table.
//  - The chunk path (chunk_tile), for entry point 2) and the mixed kernel's chunk
//    and pad rows: a group of 4 warps owns a tile of 64 query rows (row =
//    t G + g, 16 a warp) of one (row, kv head) and runs on
//    mma.sync.m16n8k16 (bf16 in, float32 accumulate) with the tensor-core
//    helpers of tc_common.cuh shared with flash_attention.cu: key tiles of
//    BK keys (64; 32 at hd 128) gathered page by page through the block
//    table (key j of the tile at page (k0 + j) / page, row (k0 + j) % page,
//    any page size) by cp.async into XOR-swizzled tiles, a two-stage ring;
//    keys past the table and out-of-pool slots are zero-filled. S = Q K^T,
//    the online softmax on the fragments, P rounded to bf16 in registers as
//    the A operand of O += P V. Masks only on tiles crossing the causal
//    edge or the table's end; every tile uses the same arithmetic (natural
//    units, expf), so a row's bits never depend on which tiles needed the
//    mask. The key tiles stop after the last key the tile's rows need: a
//    live row has key 0 unmasked, so its max is finite from the first tile
//    and later masked keys add exactly 0.
//  - The mixed kernel's decode lanes: their live row (t < n_real) goes
//    through the decode path; their fully masked tail rows (never read by
//    the caller) all equal the uniform mean of V over the lane's read_pps
//    pages, computed once per (lane, kv head) by a length-0 decode pass and
//    written to every tail row, instead of sweeping every page per tile.
//  Bit-identity: a row's arithmetic depends only on its own q, its pages
//  and the fixed geometry (page-to-warp map, tile rows counted from the
//  row's t = 0, key tiles from key 0), never on the kernel or on what else
//  rides the launch, and every floating-point step is an explicit
//  round-to-nearest intrinsic under -fmad=false. So the mixed kernel's
//  decode lanes equal the decode kernels' rows and its chunk rows equal
//  the prefill kernel's, and split equals pool, bit for bit. bf16 takes hd
//  32, 64 and 128 (rows of a power-of-two count of 16-byte chunks); every
//  operand is read in 16-byte pieces, so it starts on a 16-byte boundary.
//  No launch synchronises with the host or allocates.
//
// float32 (exact, off the serving path): the first design, kept. A block
// owns (sequence or packed row, kv head h, tile of up to 32 query rows) and
// walks that sequence's pages IN ORDER, loading its block-table entries
// itself (the TPU's scalar prefetch); each page's K and V for head h are
// staged in shared memory as float once and serve every query row of the
// tile. The per-row step is ONE __device__ function (row_page_step) called
// by every kernel: lane j scores key j, the warp reduces max and sum with
// shuffles, each lane accumulates output dims lane, lane + 32, ... Every
// floating-point operation of the step is an explicit round-to-nearest
// intrinsic, so the per-request kernels agree with the mixed kernel bit for
// bit. Masked keys score the finite NEG_INF = -1e30 (a fully masked row
// becomes the uniform mean over every swept page, never NaN); the final
// division uses l == 0 -> 1. Pool offsets are computed in 64 bits. A tile
// whose rows are all live stops after the last page any row needs
// (bit-identical to the full sweep); a tile holding a fully masked row
// sweeps every page, as the reference does.
//
// 5) aqua_write_kv_rows replaces append_kv (_append_kernel) together with
//    the reference's chunk writer (repro/layers/attention.py:
//    write_chunk_pages): ONE launch writes every new token of a packed step
//    through its row's block table, in place,
//      for r < R, t < n_write[r]:  pos = q_starts[r] + t
//        pool[bt[r, pos / page], 0|1, :, pos % page, :] = k_new|v_new[r, t]
//    (decode lanes write 1 token, chunk rows their Tc, bucket-pad rows 0).
//    Bound: bytes, each written token's K and V rows read once and written
//    once (4 KiB a token at K 16, hd 64, bf16); one decode lane's token is
//    too little to fill the card, so the design is about latency: the grid
//    runs over the flattened (row, token) pairs that have work (a warp
//    finds its row and the row's start by a shuffle scan of n_write and
//    q_starts, no host round trip), one warp moves one token's K and V
//    rows in 16-byte vectors (4-byte for float32 pools), its first loads
//    issued before the slot lookup so the two round trips overlap, all of
//    a lane's loads in flight before its stores, reads of k_new/v_new
//    contiguous and each head row's 128 bytes written by 8 neighbouring
//    lanes. hd is a template parameter, so a vector's
//    head and chunk come from shifts, not divisions. A position before 0,
//    a page index at or past the table's width and a slot outside the pool
//    are skipped; no table row is read past its width. The TPU's
//    input-output aliasing becomes a plain in-place store. Only the scratch
//    page takes duplicate writes (idle lanes, a chunk's padding past its
//    pages), a benign race.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxHd = 128;
constexpr int kHdRegs = kMaxHd / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bfloat16: the decode path and the tensor-core chunk path (design note at
// the top of the file)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kDecHeads = 4;     // query heads of one decode pass
constexpr int kTileRows = 64;    // query rows of a chunk tile: 4 warps x 16

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Decode geometry: a lane holds 16-byte chunk c of key kk of each load
// (CH chunks a key row, KPL keys a warp load); NS loads make a step of KS
// keys of one page.
template <int HD>
struct Dec {
  static constexpr int CH = HD / 8;
  static constexpr int KPL = 32 / CH;
  static constexpr int NS = HD == 128 ? 4 : 16 / KPL;
  static constexpr int KS = KPL * NS;
};

// Shared memory of a decode pass, in floats: each warp's (acc, m, l) per
// head, then the pass's normalised rows.
template <int HD>
constexpr int dec_smem_floats() {
  return kWarps * kDecHeads * (HD + 2) + kDecHeads * HD;
}
template <int HD>
__device__ __forceinline__ float* dec_res(float* f) {
  return f + kWarps * kDecHeads * (HD + 2);
}

// THE decode path. One query token's attention for ng <= kDecHeads query
// heads of kv head h (q: their rows, contiguous), keys at k_pos < length
// over the pages listed in bt, the block's 8 warps splitting the pages
// (page i on warp i % 8). length 0 leaves every key masked: the uniform
// mean of V over all pps pages (q and K unread). Leaves the normalised rows
// in dec_res(f)[gg * HD + d]; the whole block calls it.
template <int HD, typename Layout>
__device__ void decode_pass(const bf16* __restrict__ q, int ng,
                            const bf16* __restrict__ k_base,
                            const bf16* __restrict__ v_base,
                            const Layout& lay, const int* __restrict__ bt,
                            int h, int page, int pps, int length, float scale,
                            float* f) {
  using C = Dec<HD>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = lane / C::CH, c = lane % C::CH;
  const bool live = length >= 1;
  const int q_pos = length - 1;
  // the cut: a live row's last page is the one holding q_pos; every page
  // before it holds an unmasked key, the pages after it would add exactly 0
  const int n_pages = live ? min(pps, q_pos / page + 1) : pps;

  float qf[kDecHeads][8];
  float m[kDecHeads], l[kDecHeads], acc[kDecHeads][8];
#pragma unroll
  for (int gg = 0; gg < kDecHeads; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gg][e] = qf[gg][e] = 0.f;
    if (live && gg < ng) unpack8(ldg16(q + gg * HD + c * 8), qf[gg]);
  }

  for (int i = warp; i < n_pages; i += kWarps) {
    const long long slot = bt[i];
    const bool ok = slot >= 0 && slot < lay.n_slots;
    const bf16* kp = k_base + (ok ? lay.k_off(slot, h) : 0);
    const bf16* vp = v_base + (ok ? lay.v_off(slot, h) : 0);
    for (int j0 = 0; j0 < page; j0 += C::KS) {
      uint4 kr[C::NS], vr[C::NS];
#pragma unroll
      for (int s = 0; s < C::NS; ++s) {   // every load of the step in flight
        const int j = j0 + s * C::KPL + kk;
        const bool in = ok && j < page;
        const long long at = static_cast<long long>(j) * HD + c * 8;
        kr[s] = in && live ? ldg16(kp + at) : make_uint4(0, 0, 0, 0);
        vr[s] = in ? ldg16(vp + at) : make_uint4(0, 0, 0, 0);
      }
      float vf[C::NS][8];
#pragma unroll
      for (int s = 0; s < C::NS; ++s) unpack8(vr[s], vf[s]);
#pragma unroll
      for (int gg = 0; gg < kDecHeads; ++gg) {
        if (gg >= ng) break;                // warp-uniform
        float x[C::NS];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int s = 0; s < C::NS; ++s) {
          float kf[8];
          unpack8(kr[s], kf);
          // a tree over the lane's 8 dims, then over the key's CH lanes
          const float* a = qf[gg];
          float d = __fadd_rn(
              __fadd_rn(__fmaf_rn(a[1], kf[1], __fmul_rn(a[0], kf[0])),
                        __fmaf_rn(a[3], kf[3], __fmul_rn(a[2], kf[2]))),
              __fadd_rn(__fmaf_rn(a[5], kf[5], __fmul_rn(a[4], kf[4])),
                        __fmaf_rn(a[7], kf[7], __fmul_rn(a[6], kf[6]))));
#pragma unroll
          for (int o = 1; o < C::CH; o <<= 1)
            d = __fadd_rn(d, __shfl_xor_sync(kFull, d, o));
          const int j = j0 + s * C::KPL + kk;
          x[s] = j >= page ? -CUDART_INF_F               // no key
                 : live && i * page + j <= q_pos ? __fmul_rn(d, scale)
                                                 : kNegInf;
          mx = fmaxf(mx, x[s]);
        }
#pragma unroll
        for (int o = C::CH; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[gg], mx);
        const float alpha = expf(__fsub_rn(m[gg], m_new));
        float ps = 0.f;
#pragma unroll
        for (int s = 0; s < C::NS; ++s) {
          x[s] = expf(__fsub_rn(x[s], m_new));
          ps = __fadd_rn(ps, x[s]);
        }
        l[gg] = __fmaf_rn(alpha, l[gg], ps);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float o = __fmul_rn(acc[gg][e], alpha);
#pragma unroll
          for (int s = 0; s < C::NS; ++s) o = __fmaf_rn(x[s], vf[s][e], o);
          acc[gg][e] = o;
        }
        m[gg] = m_new;
      }
    }
  }

  // each warp's state: sum l and acc over the lanes of different keys
  float* part = f;                                   // [warp][head][HD]
  float* ml = f + kWarps * kDecHeads * HD;           // [warp][head][m, l]
#pragma unroll
  for (int gg = 0; gg < kDecHeads; ++gg) {
    if (gg >= ng) break;
#pragma unroll
    for (int o = C::CH; o < 32; o <<= 1) {
      l[gg] = __fadd_rn(l[gg], __shfl_xor_sync(kFull, l[gg], o));
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[gg][e] = __fadd_rn(acc[gg][e],
                               __shfl_xor_sync(kFull, acc[gg][e], o));
    }
    if (kk == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        part[(warp * kDecHeads + gg) * HD + c * 8 + e] = acc[gg][e];
    }
    if (lane == 0) {
      ml[(warp * kDecHeads + gg) * 2] = m[gg];
      ml[(warp * kDecHeads + gg) * 2 + 1] = l[gg];
    }
  }
  __syncthreads();
  // combine the warps in warp order. A warp that saw only masked keys (or
  // no page) holds m = -1e30, possibly with l > 0; beside a live warp its
  // scale exp(-1e30 - M) is exactly 0, so it adds +0 and the cut equals
  // the full sweep bit for bit. With every key masked, M = -1e30 and every
  // scale is 1: the uniform mean.
  float* res = dec_res<HD>(f);
  for (int e = threadIdx.x; e < ng * HD; e += blockDim.x) {
    const int gg = e / HD, d = e % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, ml[(w * kDecHeads + gg) * 2]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sw = expf(__fsub_rn(ml[(w * kDecHeads + gg) * 2], M));
      L = __fmaf_rn(sw, ml[(w * kDecHeads + gg) * 2 + 1], L);
      O = __fmaf_rn(sw, part[(w * kDecHeads + gg) * HD + d], O);
    }
    res[e] = __fdividef(O, L == 0.f ? 1.f : L);
  }
  __syncthreads();
}

// the pass's ng rows (heads contiguous) to out
template <int HD>
__device__ __forceinline__ void store_heads(float* f, bf16* out, int ng) {
  const float* res = dec_res<HD>(f);
  for (int e = threadIdx.x; e < ng * HD; e += blockDim.x)
    out[e] = __float2bfloat16(res[e]);
}

// Every query head of one token of sequence (or packed row) b: passes of
// kDecHeads heads, each through decode_pass.
template <int HD, typename Layout>
__device__ __forceinline__ void decode_token(
    const bf16* __restrict__ q, bf16* __restrict__ out, int G,
    const bf16* __restrict__ k_base, const bf16* __restrict__ v_base,
    const Layout& lay, const int* __restrict__ bt, int h, int page, int pps,
    int length, float scale, float* f) {
  for (int g0 = 0; g0 < G; g0 += kDecHeads) {
    const int ng = min(kDecHeads, G - g0);
    decode_pass<HD>(q + g0 * HD, ng, k_base, v_base, lay, bt, h, page, pps,
                    length, scale, f);
    store_heads<HD>(f, out + g0 * HD, ng);
  }
}

template <int HD>
struct Chunk {
  static constexpr int BK = HD == 128 ? 32 : 64;   // keys of a tile
  static constexpr size_t kSmem =
      static_cast<size_t>(kTileRows + 4 * BK) * HD * 2;   // Q, K and V rings
};

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(grp + 1) : "memory");
}

// THE chunk path. Causal attention of one tile of kTileRows query rows
// (row = t G + g, from row0) of a chunk of Tc tokens at q_start + t for kv
// head h, every row live (pad rows too), run by one group of 4 warps (grp:
// threads 128 grp ..) on the tensor cores. Key tiles of BK keys are
// gathered page by page through bt into a two-stage cp.async ring; keys
// past the table and out-of-pool slots read as zeros. tok0: q's and out's
// token index of the chunk's t = 0.
template <int HD>
__device__ void chunk_tile(const bf16* __restrict__ q,
                           const bf16* __restrict__ pool, const FusedPool& lay,
                           const int* __restrict__ bt, bf16* __restrict__ out,
                           long long tok0, int Tc, int H, int G, int h,
                           int row0, int q_start, int page, int pps,
                           float scale, unsigned char* smem, int grp) {
  constexpr int BK = Chunk<HD>::BK, CH = HD / 8, NT = 128;
  const int n_rows = Tc * G;
  const int tid = threadIdx.x & (NT - 1);
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = warp * 16, gq = lane >> 2, tq = lane & 3;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTileRows * HD;       // two stages
  bf16* sV = sK + 2 * BK * HD;          // two stages
  const int t_first = row0 / G;
  const int t_last = (min(n_rows, row0 + kTileRows) - 1) / G;
  const int table_keys = pps * page;
  // the cut: the tile's key tiles end at its last row's position
  const int n_keys = min(q_start + t_last + 1, table_keys);
  const int n_tiles = n_keys > 0 ? (n_keys + BK - 1) / BK : 0;

  {
    const uint32_t base = saddr(sQ);
#pragma unroll
    for (int i = 0; i < kTileRows * CH / NT; ++i) {
      const int e = tid + i * NT, r = e / CH, cc = e % CH;
      const int row = row0 + r;
      const bool in = row < n_rows;
      const long long at =
          in ? ((tok0 + row / G) * H + h * G + row % G) * HD + cc * 8 : 0;
      cp_async16(base + 2 * swz<HD>(r, cc), q + at, in ? 16 : 0);
    }
  }
  auto load_kv = [&](int kt, int st) {
    const uint32_t kb = saddr(sK + st * BK * HD);
    const uint32_t vb = saddr(sV + st * BK * HD);
#pragma unroll
    for (int i = 0; i < BK * CH / NT; ++i) {
      const int e = tid + i * NT, j = e / CH, cc = e % CH;
      const int key = kt * BK + j;
      const int pi = key / page;
      const long long slot = key < table_keys ? bt[pi] : -1;
      const bool ok = slot >= 0 && slot < lay.n_slots;
      const long long row =
          ok ? static_cast<long long>(key - pi * page) * HD + cc * 8 : 0;
      cp_async16(kb + 2 * swz<HD>(j, cc),
                 pool + (ok ? lay.k_off(slot, h) + row : 0), ok ? 16 : 0);
      cp_async16(vb + 2 * swz<HD>(j, cc),
                 pool + (ok ? lay.v_off(slot, h) + row : 0), ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_commit();

  const uint32_t tQ = saddr(sQ);
  const bool rows_here = row0 + m0 < n_rows;     // warp-uniform
  const int qp[2] = {q_start + (row0 + m0 + gq) / G,
                     q_start + (row0 + m0 + gq + 8) / G};
  uint32_t no_regs[1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_tiles) load_kv(kt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    group_sync(grp);
    if (rows_here) {
      float sc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      mma_abt<HD, BK, false>(sc, no_regs, tQ, m0, saddr(sK + st * BK * HD),
                             lane);
      // one arithmetic on every tile (natural units, expf), so a row's
      // result never depends on which tiles need the mask; masked and
      // absent keys add exactly 0 to a live row
      const bool masked =
          k0 + BK - 1 > q_start + t_first || k0 + BK > table_keys;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(sc[j][e], scale);
          if (masked) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            if (kp > qp[e >> 1] || kp >= table_keys) x = kNegInf;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = expf(__fsub_rn(m_r[i], m_new));
        m_r[i] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(sc[j][e], m_r[e >> 1]));
          sc[j][e] = p;
          ps[e >> 1] = __fadd_rn(ps[e >> 1], p);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = __fmaf_rn(alpha[i], l_r[i], ps[i]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fmul_rn(acc[j][e], alpha[e >> 1]);
      uint32_t pf[BK / 16][4];
      to_a<BK>(pf, sc);
      mma_ab<HD, BK, HD>(acc, pf, saddr(sV + st * BK * HD), 0, lane);
    }
    group_sync(grp);   // the next iteration's copy overwrites this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l = __fadd_rn(l, __shfl_xor_sync(kFull, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(kFull, l, 2));
    if (l == 0.f) l = 1.f;
    const int row = row0 + m0 + gq + 8 * i;
    if (row >= n_rows) continue;
    bf16* o = out + ((tok0 + row / G) * H + h * G + row % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(__fdividef(acc[j][2 * i], l),
                                __fdividef(acc[j][2 * i + 1], l));
  }
}

template <int HD>
constexpr size_t mixed_smem() {
  return 2 * Chunk<HD>::kSmem > dec_smem_floats<HD>() * sizeof(float)
             ? 2 * Chunk<HD>::kSmem
             : dec_smem_floats<HD>() * sizeof(float);
}

// Mixed step: block (packed row r, kv head h, z). A chunk row's block runs
// two tiles (2 z and 2 z + 1), one per group of 4 warps. A decode lane's
// z = 0 block runs its live rows (t < n_real; one, as the engine packs it)
// through the decode path, then its fully masked tail rows: their value,
// the uniform mean of V over the lane's read_pps pages, is the same for
// every tail row and head of the lane, so one length-0 pass computes it and
// the block writes it to each; its other blocks exit.
template <int HD>
__global__ void __launch_bounds__(kWarps * 32, 1)
    paged_mixed_tc(const bf16* __restrict__ q, const bf16* __restrict__ pool,
                   FusedPool lay, const int* __restrict__ block_tables,
                   const int* __restrict__ q_starts,
                   const int* __restrict__ n_reals,
                   const int* __restrict__ is_decode, bf16* __restrict__ out,
                   int Tc, int H, int K, int page, int read_pps,
                   int bt_stride, float scale) {
  extern __shared__ __align__(128) unsigned char smem_pa[];
  const int G = H / K, r = blockIdx.x, h = blockIdx.y;
  const int* bt = block_tables + static_cast<long long>(r) * bt_stride;
  const long long tok0 = static_cast<long long>(r) * Tc;
  const int q_start = q_starts[r];
  if (is_decode[r] == 0) {
    const int grp = threadIdx.x >> 7;
    const int row0 = (2 * blockIdx.z + grp) * kTileRows;
    if (row0 >= Tc * G) return;                 // group-uniform
    chunk_tile<HD>(q, pool, lay, bt, out, tok0, Tc, H, G, h, row0, q_start,
                   page, read_pps, scale, smem_pa + grp * Chunk<HD>::kSmem,
                   grp);
    return;
  }
  if (blockIdx.z != 0) return;
  float* f = reinterpret_cast<float*>(smem_pa);
  const int n_live = min(max(n_reals[r], 0), Tc);
  for (int t = 0; t < n_live; ++t) {
    const long long at = ((tok0 + t) * H + h * G) * HD;
    decode_token<HD>(q + at, out + at, G, pool, pool, lay, bt, h, page,
                     read_pps, q_start + 1, scale, f);
  }
  if (n_live == Tc) return;
  decode_pass<HD>(q, 1, pool, pool, lay, bt, h, page, read_pps, 0, scale, f);
  // the mean as 16-byte chunks, to every tail row of every head of the group
  constexpr int CH = HD / 8;
  const float* mean = dec_res<HD>(f);
  const int n = (Tc - n_live) * G * CH;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int cc = e % CH, row = e / CH;
    const int t = n_live + row / G, g = row % G;
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack_bf16(mean[cc * 8 + 2 * i], mean[cc * 8 + 2 * i + 1]);
    *reinterpret_cast<uint4*>(out + ((tok0 + t) * H + h * G + g) * HD +
                              cc * 8) = v;
  }
}

// Chunked prefill: block (sequence b, kv head h, tile z), one group.
template <int HD>
__global__ void __launch_bounds__(128)
    paged_prefill_tc(const bf16* __restrict__ q, const bf16* __restrict__ pool,
                     FusedPool lay, const int* __restrict__ block_tables,
                     const int* __restrict__ q_starts, bf16* __restrict__ out,
                     int Tc, int H, int K, int page, int read_pps,
                     int bt_stride, float scale) {
  extern __shared__ __align__(128) unsigned char smem_pa[];
  const int b = blockIdx.x;
  chunk_tile<HD>(q, pool, lay,
                 block_tables + static_cast<long long>(b) * bt_stride, out,
                 static_cast<long long>(b) * Tc, Tc, H, H / K, blockIdx.y,
                 blockIdx.z * kTileRows, q_starts[b], page, read_pps, scale,
                 smem_pa, 0);
}

// Decode over either pool layout: block (sequence b, kv head h).
template <int HD, typename Layout>
__global__ void __launch_bounds__(kWarps * 32, 1)
    paged_decode_tc(const bf16* __restrict__ q, const bf16* __restrict__ k_base,
                    const bf16* __restrict__ v_base, Layout lay,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    int H, int K, int page, int pps, int bt_stride,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem_pa[];
  const int b = blockIdx.x, h = blockIdx.y, G = H / K;
  const long long at = (static_cast<long long>(b) * H + h * G) * HD;
  decode_token<HD>(q + at, out + at, G, k_base, v_base, lay,
                   block_tables + static_cast<long long>(b) * bt_stride, h,
                   page, pps, lengths[b], scale,
                   reinterpret_cast<float*>(smem_pa));
}

template <int HD>
int mixed(const void* q, const void* pool, const int* bt, const int* q_starts,
          const int* n_reals, const int* is_dec, void* out, int R, int Tc,
          int H, int K, int page, int read_pps, int bt_stride,
          long long n_pool, float scale, cudaStream_t stream) {
  constexpr size_t smem = mixed_smem<HD>();
  if (int e = set_smem(paged_mixed_tc<HD>, smem)) return e;
  const int tiles = (Tc * (H / K) + kTileRows - 1) / kTileRows;
  const FusedPool lay{n_pool, K, static_cast<long long>(page) * HD};
  paged_mixed_tc<HD><<<dim3(R, K, (tiles + 1) / 2), kWarps * 32, smem,
                       stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool), lay, bt,
      q_starts, n_reals, is_dec, static_cast<bf16*>(out), Tc, H, K, page,
      read_pps, bt_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int prefill(const void* q, const void* pool, const int* bt,
            const int* q_starts, void* out, int B, int Tc, int H, int K,
            int page, int read_pps, int bt_stride, long long n_pool,
            float scale, cudaStream_t stream) {
  constexpr size_t smem = Chunk<HD>::kSmem;
  if (int e = set_smem(paged_prefill_tc<HD>, smem)) return e;
  const int tiles = (Tc * (H / K) + kTileRows - 1) / kTileRows;
  const FusedPool lay{n_pool, K, static_cast<long long>(page) * HD};
  paged_prefill_tc<HD><<<dim3(B, K, tiles), 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool), lay, bt,
      q_starts, static_cast<bf16*>(out), Tc, H, K, page, read_pps, bt_stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename Layout>
int decode(const void* q, const void* k, const void* v, const Layout& lay,
           const int* bt, const int* lengths, void* out, int B, int H, int K,
           int page, int pps, int bt_stride, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = dec_smem_floats<HD>() * sizeof(float);
  if (int e = set_smem(paged_decode_tc<HD, Layout>, smem)) return e;
  paged_decode_tc<HD, Layout><<<dim3(B, K), kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lay, bt, lengths, static_cast<bf16*>(out),
      H, K, page, pps, bt_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int info_of(int part, int* out) {
  constexpr size_t dec = dec_smem_floats<HD>() * sizeof(float);
  switch (part) {
    case 0: return info(paged_mixed_tc<HD>, mixed_smem<HD>(), out);
    case 1: return info(paged_prefill_tc<HD>, Chunk<HD>::kSmem, out);
    case 2: return info(paged_decode_tc<HD, FusedPool>, dec, out);
    case 3: return info(paged_decode_tc<HD, SplitPools>, dec, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// f(std::integral_constant<int, hd>) for the bf16 head dims: rows of a
// power-of-two count of 16-byte chunks, as the swizzle and the decode
// lanes need; any other hd is refused
template <typename F>
int by_hd(int hd, F&& f) {
  switch (hd) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// Row writer (entry point 5): 4 warps a block, one (row, token) pair a
// warp; a lane keeps kUnroll vectors of K and of V in flight.
constexpr int kWriterWarps = 4;
constexpr int kUnroll = 4;

// Tokens row r writes: n_write[r] clamped to [0, T] (all T when n_write is
// null).
__device__ __forceinline__ long long row_tokens(const int* n_write, int r,
                                                int T) {
  return n_write ? min(max(n_write[r], 0), T) : T;
}

// The row holding flattened pair i (pairs counted row by row over the
// rows' token counts), the pair index its row starts at and the row's
// q_start; -1 past the last pair. Warp-uniform: 32 rows a step, each lane
// loading its row's count and start together, an inclusive shuffle scan.
__device__ __forceinline__ int pair_row(const int* n_write,
                                        const int* q_starts, int R, int T,
                                        long long i, long long* row_start,
                                        int* q_start) {
  const int lane = threadIdx.x & 31;
  long long base = 0;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int r = r0 + lane;
    const long long n = r < R ? row_tokens(n_write, r, T) : 0;
    const int qs = r < R ? q_starts[r] : 0;
    long long incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(kFull, base + incl > i);
    if (hit) {
      const int l = __ffs(hit) - 1;
      *row_start = base + __shfl_sync(kFull, incl - n, l);
      *q_start = __shfl_sync(kFull, qs, l);
      return r0 + l;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  return -1;
}

// A lane's vectors v0 + 32 u (u < kUnroll) of one token's K and V rows.
template <typename Vec>
__device__ __forceinline__ void load_rows(Vec (&kb)[kUnroll],
                                          Vec (&vb)[kUnroll],
                                          const Vec* __restrict__ k_new,
                                          const Vec* __restrict__ v_new,
                                          long long src, int v0,
                                          int row_vecs) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int v = v0 + 32 * u;
    if (v < row_vecs) {
      kb[u] = k_new[src + v];
      vb[u] = v_new[src + v];
    }
  }
}

// Vec: the unit a lane moves (uint4 for 2-byte elements, uint32_t for
// 4-byte); VPR: Vecs in one head row of hd elements. A lane's first
// vectors of K and V are loaded before the slot is looked up, so the two
// round trips overlap.
template <typename Vec, int VPR>
__global__ void __launch_bounds__(kWriterWarps * 32)
write_kv_rows_kernel(Vec* __restrict__ pool, const Vec* __restrict__ k_new,
                     const Vec* __restrict__ v_new,
                     const int* __restrict__ bt,
                     const int* __restrict__ q_starts,
                     const int* __restrict__ n_write, int R, int T, int K,
                     int page, int bt_width, int bt_stride,
                     long long n_pool) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWriterWarps + (threadIdx.x >> 5);
  long long row_start = 0;
  int q_start = 0;
  const int r = pair_row(n_write, q_starts, R, T, i, &row_start, &q_start);
  if (r < 0) return;
  const int t = static_cast<int>(i - row_start);
  const int lane = threadIdx.x & 31;
  const int row_vecs = K * VPR;                  // one token's K (or V)
  const long long src = (static_cast<long long>(r) * T + t) * row_vecs;
  Vec kb[kUnroll] = {}, vb[kUnroll] = {};
  load_rows(kb, vb, k_new, v_new, src, lane, row_vecs);
  const long long pos = static_cast<long long>(q_start) + t;
  if (pos < 0) return;
  const long long pi = pos / page;
  if (pi >= bt_width) return;
  const long long slot = bt[static_cast<long long>(r) * bt_stride + pi];
  if (slot < 0 || slot >= n_pool) return;
  const long long head_vecs = static_cast<long long>(page) * VPR;
  const long long k_dst =
      slot * 2 * K * head_vecs + (pos - pi * page) * VPR;
  const long long v_dst = k_dst + K * head_vecs;
  for (int v0 = lane;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + 32 * u;
      if (v < row_vecs) {
        const long long d = (v / VPR) * head_vecs + v % VPR;
        pool[k_dst + d] = kb[u];
        pool[v_dst + d] = vb[u];
      }
    }
    v0 += 32 * kUnroll;
    if (v0 >= row_vecs) break;
    load_rows(kb, vb, k_new, v_new, src, v0, row_vecs);
  }
}

template <typename Vec, int VPR>
int launch_write(void* pool, const void* k, const void* v, const int* bt,
                 const int* q_starts, const int* n_write, int R, int T,
                 int K, int page, int bt_width, int bt_stride,
                 long long n_pool, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(R) * T;
  const long long blocks = (pairs + kWriterWarps - 1) / kWriterWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  write_kv_rows_kernel<Vec, VPR><<<static_cast<unsigned>(blocks),
                                   kWriterWarps * 32, 0, stream>>>(
      static_cast<Vec*>(pool), static_cast<const Vec*>(k),
      static_cast<const Vec*>(v), bt, q_starts, n_write, R, T, K, page,
      bt_width, bt_stride, n_pool);
  return static_cast<int>(cudaGetLastError());
}

// f(Vec, VPR) for a pool of elem_bytes-byte elements at head dim hd: 16-byte
// vectors for 2-byte elements, 4-byte ones for 4-byte elements.
template <typename F>
int by_row(int elem_bytes, int hd, F&& f) {
  return by_hd(hd, [&](auto HD) {
    constexpr int D = decltype(HD)::value;
    if (elem_bytes == 2) return f(uint4(), std::integral_constant<int, D / 8>());
    if (elem_bytes == 4) return f(uint32_t(), std::integral_constant<int, D>());
    return static_cast<int>(cudaErrorInvalidValue);
  });
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
    return by_hd(hd, [&](auto HD) {
      return tc::mixed<decltype(HD)::value>(q, pool, block_tables, q_starts, n_reals,
                             is_decode, out, R, Tc, H, K, page, read_pps,
                             bt_stride, n_pool, scale, s);
    });
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
    return by_hd(hd, [&](auto HD) {
      return tc::prefill<decltype(HD)::value>(q, pool, block_tables, q_starts, out, B, Tc,
                               H, K, page, read_pps, bt_stride, n_pool, scale,
                               s);
    });
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
    return by_hd(hd, [&](auto HD) {
      return tc::decode<decltype(HD)::value>(q, pool, pool, lay, block_tables, lengths, out,
                              B, H, K, page, pps, bt_stride, scale, s);
    });
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
    return by_hd(hd, [&](auto HD) {
      return tc::decode<decltype(HD)::value>(q, k_pages, v_pages, lay, block_tables, lengths,
                              out, B, H, K, page, pps, bt_stride, scale, s);
    });
  return -1;
}

// n_write: tokens each row writes, or null for all T; bt_stride: element
// stride between the table's rows, each row bt_width entries.
extern "C" int aqua_write_kv_rows(void* pool, const void* k_new,
                                  const void* v_new, const int* block_table,
                                  const int* q_starts, const int* n_write,
                                  int R, int T, int K, int page, int hd,
                                  int bt_width, int bt_stride,
                                  long long n_pool, int elem_bytes,
                                  void* stream) {
  if (R == 0 || T == 0) return 0;
  if (K <= 0 || page <= 0 || bt_width <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_row(elem_bytes, hd, [&](auto vec, auto vpr) {
    return launch_write<decltype(vec), decltype(vpr)::value>(
        pool, k_new, v_new, block_table, q_starts, n_write, R, T, K, page,
        bt_width, bt_stride, n_pool, s);
  });
}

// Registers and local bytes of the row writer for elem_bytes-byte elements
// at head dim hd (no shared memory).
extern "C" int aqua_write_kv_rows_info(int elem_bytes, int hd, int* out) {
  return by_row(elem_bytes, hd, [&](auto vec, auto vpr) {
    return tc::info(write_kv_rows_kernel<decltype(vec), decltype(vpr)::value>,
                    0, out);
  });
}

// Registers, local bytes (spills and stack) and dynamic shared memory of a
// bf16 kernel at head dim hd: part 0 mixed, 1 prefill, 2 decode over the
// fused pool, 3 decode over split pools.
extern "C" int aqua_paged_attention_tc_info(int part, int hd, int* out) {
  return by_hd(hd, [&](auto HD) { return tc::info_of<decltype(HD)::value>(part, out); });
}
