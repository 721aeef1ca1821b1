// Blocked causal/windowed GQA flash attention, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention/kernel.py, and adds the backward that
// the JAX package leaves to autodiff of its einsum. Layouts are the public
// ones, read in place: q, o, dO (B, Sq, H, hd); k, v (B, Sk, K, hd); the row
// log-sum-exp lse and D = rowsum(dO * O) (B, H, Sq) float32. Query head h
// reads KV head h / G (G = H / K), as the TPU kernel's index maps do.
// Queries are right-aligned (q_pos = i + Sk - Sq); a key is visible when
// causal => k_pos <= q_pos and window > 0 => q_pos - k_pos < window.
//
//   forward:  S = scale Q K^T, masked to -1e30; O = softmax(S) V;
//             lse = m + log(l)
//   backward: P = exp(S - lse); dV = P^T dO; dS = P * (dO V^T - D) on the
//             visible pairs; dQ = scale dS K; dK = scale dS^T Q
//
// Masking with -1e30, not -inf, is the reference's semantics and it is kept
// exactly: a row that sees no key (causal with Sq > Sk) gets the uniform
// softmax over all Sk keys, i.e. the mean of V, and its dV share is dO / Sk.
// The online softmax reproduces that when it starts from m = -1e30 and such
// a row's query tile sweeps every key tile; a row that does see keys wipes
// what masked keys added (alpha = e^{-1e30 - m} = 0) at its first visible
// key. So l >= 1 always, and the TPU kernel's l == 0 guard never fires.
// Keys past Sk in a ragged last tile score -inf and add nothing.
//
// Bound: at the training shape (B 4, S 2048, H 16, hd 64, bf16, causal) the
// forward does 4 B H S^2 hd / 2 = 3.4e10 FLOP (35 us at 989 TFLOP/s bf16)
// and must move 67 MB (20 us at 3.35 TB/s); the backward's five products
// 8.6e10 FLOP (87 us) and 134 MB (40 us). Both are bound by operations, so
// the bf16 path runs every product on the tensor cores.
//
// bfloat16 (the training path): namespace tc, three kernels on
// mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//  - Tiles sit in shared memory as bf16 rows of hd, their 16-byte chunks
//    XOR-swizzled by row (swz, with the cp.async, ldmatrix and mma.sync
//    helpers in tc_common.cuh, shared with paged_attention.cu) so that the eight rows an ldmatrix phase reads
//    fall in eight bank groups. ldmatrix feeds every operand: A and the
//    K-major B (K for S = Q K^T, V for dP = dO V^T) as they lie,
//    ldmatrix.trans the row-major B (V for P V, K for dS K, dO and Q for
//    the dK/dV products).
//  - K/V tiles (forward, dQ) or Q/dO tiles with their lse and D (dK/dV)
//    arrive through a two-stage cp.async ring: 16 bytes a thread, one
//    commit group per tile, the next tile's copy in flight while the
//    current one is multiplied. A row past the end is zero-filled by the
//    copy's src-size operand, so a ragged tile holds zeros, never stale
//    rows.
//  - A warp owns 16 rows. A product's accumulator fragment (rows g, g + 8
//    of the warp, columns 2t, 2t + 1 of each 8-wide tile) is the next
//    product's A fragment once rounded to bf16, so P (forward), dS (dQ) and
//    P^T, dS^T (dK/dV) never leave registers. The online softmax runs on
//    the fragments: each thread holds 2 rows, the row max takes two
//    __shfl_xor_sync inside the quad, the row sum is reduced once at the
//    end. Exponentials are exp2f with scale * log2(e) folded into one
//    multiply-add (the library builds with -fmad=false, so multiply-adds
//    are explicit __fmaf_rn). The forward's masked tiles keep the plain
//    version's expf(x - m) in natural units instead: a row that sees a few
//    keys lives there, and its lse = m + log l nearly cancels, so only the
//    same arithmetic gives the same lse.
//  - Masks are applied only on tiles that cross the diagonal, the window
//    edge, Sq or Sk (tile_masked); interior tiles run unmasked.
//  - forward: one block per (b h, 64 queries), heavy (late) causal tiles
//    first, Q's fragments loaded once into registers at hd 32 and 128; at
//    hd 64 they are read from shared memory per product, which keeps the
//    kernel at 137 registers and 3 blocks per SM (in registers ptxas capped
//    it at 168 and spilled, or, asked for 2 blocks per SM, took 199 and ran
//    slower on the H100); at hd 256 likewise, with 32-key tiles.
//  - dQ: one block per (b h, 64 queries); it computes D for its rows and
//    writes it for the dK/dV kernel, launched after it; per key tile S,
//    dP, dS = P (dP - D) in bf16, dQ += dS K in float32 registers (Q's
//    and dO's fragments in registers at hd 32, read from shared memory per
//    product above; 16-key tiles at hd 256).
//  Tiles per head dim (Cfg) are chosen so that no kernel spills: -Xptxas
//  -v must report 0 bytes of stack and spills for each (a float32
//  division's slow path alone spilled; the epilogues divide with
//  __fdividef, l >= 1, and 1 / Sk comes from the host).
//  - dK, dV: one block per (b kv-head, 64 keys), looping over the G query
//    heads of the group and the visible query tiles; S^T = K Q^T puts P^T
//    in accumulator layout, the A operand of dV += P^T dO, and dK += dS^T
//    Q; both sums stay in float32 registers: no atomics, a deterministic
//    result. At hd 256 eight warps split the output columns in two halves
//    (each computes S^T and dP^T for its 16 keys).
//  This split does 7 products where the minimum is 5 (S and dP twice):
//  the price of determinism.
//
// float32 (exact, off the training path): the first design, float32
// CUDA-core FMAs (explicit fmaf), tiles staged in shared memory as float
// with rows padded to hd + 1 floats, 256 threads laid out 16 x 16, each
// holding a register micro-tile of every product; the same three kernels
// and block layout. Tiles: 64 x 64 for hd <= 128, 32 x 32 at hd 256.
//
// Tiles fully masked by causality or the window are skipped in index space
// (a query tile with rows that see no key sweeps every key tile in the
// forward; their dQ is 0 and the dK/dV kernel keeps them in its range).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

struct Shape {
  int B, Sq, Sk, H, K, G, off;   // off = Sk - Sq
  int causal, window;
  float scale, inv_sk;           // inv_sk = 1 / Sk
};

__device__ __forceinline__ bool visible(int qp, int kp, const Shape& s) {
  return (!s.causal || kp <= qp) && (s.window <= 0 || qp - kp < s.window);
}

// A row sees no key only under causality with q_pos < 0 (with a window it
// still sees k_pos = q_pos; without causality it sees k_pos = Sk - 1).
__device__ __forceinline__ bool row_empty(int qp, const Shape& s) {
  return s.causal && qp < 0;
}

// rows [row0, row0 + ROWS) of head `head` of a (B, S, NH, HD) tensor into
// a float tile with row stride HD + 1; rows past S are zero
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int NH, int head) {
  for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = row0 + r;
    dst[r * (HD + 1) + d] =
        s < S ? to_float(src[((static_cast<size_t>(b) * S + s) * NH + head) *
                                 HD + d])
              : 0.f;
  }
}

// acc[i][j] += sum_x A[r * lda + x] * Bm[c * ldb + x]   (A B^T)
template <int M, int N, int X>
__device__ __forceinline__ void mm_nt(float (&acc)[M / 16][N / 16],
                                      const float* A, int lda, const float* Bm,
                                      int ldb, int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < X; ++x) {
    float a[M / 16], bv[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i) a[i] = A[(ty + 16 * i) * lda + x];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) bv[j] = Bm[(tx + 16 * j) * ldb + x];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_x A[r * lda + x] * Bm[x * ldb + c]   (A B)
template <int M, int N, int X>
__device__ __forceinline__ void mm_nn(float (&acc)[M / 16][N / 16],
                                      const float* A, int lda, const float* Bm,
                                      int ldb, int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < X; ++x) {
    float a[M / 16], bv[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i) a[i] = A[(ty + 16 * i) * lda + x];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) bv[j] = Bm[x * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_x A[x * lda + r] * Bm[x * ldb + c]   (A^T B)
template <int M, int N, int X>
__device__ __forceinline__ void mm_tn(float (&acc)[M / 16][N / 16],
                                      const float* A, int lda, const float* Bm,
                                      int ldb, int ty, int tx) {
#pragma unroll 4
  for (int x = 0; x < X; ++x) {
    float a[M / 16], bv[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i) a[i] = A[x * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) bv[j] = Bm[x * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M / 16][N / 16]) {
#pragma unroll
  for (int i = 0; i < M / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) acc[i][j] = 0.f;
}

// sum of x over the TPR consecutive lanes that hold one row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// key tiles [lo, hi) with a key visible to a query row of [q0, q0 + rows)
// that sees keys at all
__device__ __forceinline__ void key_tiles(int q0, int rows, int BK,
                                          const Shape& s, int* lo, int* hi) {
  const int qp_first = q0 + s.off;
  const int qp_last = min(q0 + rows, s.Sq) - 1 + s.off;
  int k_lo = 0, k_hi = s.Sk;
  if (s.causal) k_hi = min(s.Sk, qp_last + 1);
  if (s.window > 0) k_lo = max(0, qp_first - s.window + 1);
  *lo = k_lo / BK;
  *hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : *lo;
}

template <int BQ, int BK, int HD>
constexpr size_t fwd_smem_floats() {
  return (BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Shape s) {
  constexpr int LDH = HD + 1, LDP = BK + 1, TPR = kThreads / BQ;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDH;
  float* sV = sK + BK * LDH;
  float* sP = sV + BK * LDH;
  float* sM = sP + BQ * LDP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, kh = h / s.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, BQ, HD>(sQ, q, b, q0, s.Sq, s.H, h);
  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = kMasked;
    sL[r] = 0.f;
  }
  int kt_lo, kt_hi;
  if (row_empty(q0 + s.off, s)) {
    kt_lo = 0;   // rows that see no key average V over every key
    kt_hi = (s.Sk + BK - 1) / BK;
  } else {
    key_tiles(q0, BQ, BK, s, &kt_lo, &kt_hi);
  }
  float acc[BQ / 16][HD / 16];
  zero<BQ, HD>(acc);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, HD>(sK, k, b, k0, s.Sk, s.K, kh);
    load_tile<T, BK, HD>(sV, v, b, k0, s.Sk, s.K, kh);
    __syncthreads();
    float sc[BQ / 16][BK / 16];
    zero<BQ, BK>(sc);
    mm_nt<BQ, BK, HD>(sc, sQ, LDH, sK, LDH, ty, tx);
#pragma unroll
    for (int i = 0; i < BQ / 16; ++i) {
      const int r = ty + 16 * i, qp = q0 + r + s.off;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        float x = sc[i][j] * s.scale;
        if (kp >= s.Sk) x = -INFINITY;
        else if (!visible(qp, kp, s)) x = kMasked;
        sP[r * LDP + c] = x;
      }
    }
    __syncthreads();
    {  // online softmax: TPR consecutive threads per row
      const int r = tid / TPR, part = tid % TPR;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += TPR) mx = fmaxf(mx, sP[r * LDP + c]);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, row_max<TPR>(mx));
      float sum = 0.f;
      for (int c = part; c < BK; c += TPR) {
        const float p = expf(sP[r * LDP + c] - m_new);
        sP[r * LDP + c] = p;
        sum += p;
      }
      sum = row_sum<TPR>(sum);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sM[r] = m_new;
        sL[r] = fmaf(alpha, sL[r], sum);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BQ / 16; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= alpha;
    }
    mm_nn<BQ, HD, BK>(acc, sP, LDP, sV, LDH, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= s.Sq) continue;
    const float l = sL[r];
    T* orow = o + ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] / l);
  }
  for (int r = tid; r < BQ; r += kThreads)
    if (q0 + r < s.Sq)
      lse[static_cast<size_t>(bh) * s.Sq + q0 + r] = sM[r] + logf(sL[r]);
}

template <int BQ, int BK, int HD>
constexpr size_t dq_smem_floats() {
  return 2 * (BQ + BK) * (HD + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ Dg,
                        T* __restrict__ dq, Shape s) {
  constexpr int LDH = HD + 1, LDP = BK + 1, TPR = kThreads / BQ;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDH;
  float* sK = sdO + BQ * LDH;
  float* sV = sK + BK * LDH;
  float* sS = sV + BK * LDH;
  float* sLse = sS + BQ * LDP;
  float* sD = sLse + BQ;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, kh = h / s.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, BQ, HD>(sQ, q, b, q0, s.Sq, s.H, h);
  load_tile<T, BQ, HD>(sdO, dout, b, q0, s.Sq, s.H, h);
  __syncthreads();
  {  // D = rowsum(dO * O), TPR threads per row
    const int r = tid / TPR, part = tid % TPR, qi = q0 + r;
    float d = 0.f;
    if (qi < s.Sq) {
      const T* orow = o + ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD;
      for (int x = part; x < HD; x += TPR)
        d = fmaf(sdO[r * LDH + x], to_float(orow[x]), d);
    }
    d = row_sum<TPR>(d);
    if (part == 0) {
      sD[r] = d;
      sLse[r] = qi < s.Sq ? lse[static_cast<size_t>(bh) * s.Sq + qi] : 0.f;
      if (qi < s.Sq) Dg[static_cast<size_t>(bh) * s.Sq + qi] = d;
    }
  }
  int kt_lo, kt_hi;
  key_tiles(q0, BQ, BK, s, &kt_lo, &kt_hi);
  float acc[BQ / 16][HD / 16];
  zero<BQ, HD>(acc);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, HD>(sK, k, b, k0, s.Sk, s.K, kh);
    load_tile<T, BK, HD>(sV, v, b, k0, s.Sk, s.K, kh);
    __syncthreads();
    float sc[BQ / 16][BK / 16], dp[BQ / 16][BK / 16];
    zero<BQ, BK>(sc);
    zero<BQ, BK>(dp);
    mm_nt<BQ, BK, HD>(sc, sQ, LDH, sK, LDH, ty, tx);
    mm_nt<BQ, BK, HD>(dp, sdO, LDH, sV, LDH, ty, tx);
#pragma unroll
    for (int i = 0; i < BQ / 16; ++i) {
      const int r = ty + 16 * i, qp = q0 + r + s.off;
      const float l = sLse[r], d = sD[r];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        float ds = 0.f;
        if (kp < s.Sk && visible(qp, kp, s))
          ds = expf(sc[i][j] * s.scale - l) * (dp[i][j] - d);
        sS[r * LDP + c] = ds;
      }
    }
    __syncthreads();
    mm_nn<BQ, HD, BK>(acc, sS, LDP, sK, LDH, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < BQ / 16; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s.Sq) continue;
    T* row = dq + ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      row[tx + 16 * j] = from_float<T>(acc[i][j] * s.scale);
  }
}

template <int BQ, int BK, int HD>
constexpr size_t dkdv_smem_floats() {
  return 2 * (BQ + BK) * (HD + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ Dg, T* __restrict__ dk,
                          T* __restrict__ dv, Shape s) {
  constexpr int LDH = HD + 1, LDP = BK + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LDH;
  float* sQ = sV + BK * LDH;
  float* sdO = sQ + BQ * LDH;
  float* sP = sdO + BQ * LDH;
  float* sS = sP + BQ * LDP;
  float* sLse = sS + BQ * LDP;
  float* sD = sLse + BQ;
  const int bk = blockIdx.y, b = bk / s.K, kh = bk % s.K;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, BK, HD>(sK, k, b, k0, s.Sk, s.K, kh);
  load_tile<T, BK, HD>(sV, v, b, k0, s.Sk, s.K, kh);
  // query rows with a visible key in this tile, and every row that sees no
  // key at all (the first -off rows when causal with Sq > Sk)
  const int k_last = min(k0 + BK, s.Sk) - 1;
  int i_lo = 0, i_hi = s.Sq;
  if (s.causal && s.off >= 0) i_lo = max(0, k0 - s.off);
  if (s.window > 0) i_hi = min(s.Sq, k_last + s.window - s.off);
  const int qt_lo = i_lo / BQ, qt_hi = i_hi > i_lo ? (i_hi + BQ - 1) / BQ : 0;

  float ak[BK / 16][HD / 16], av[BK / 16][HD / 16];
  zero<BK, HD>(ak);
  zero<BK, HD>(av);
  for (int g = 0; g < s.G; ++g) {
    const int h = kh * s.G + g;
    const size_t row_base = static_cast<size_t>(b * s.H + h) * s.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, BQ, HD>(sQ, q, b, q0, s.Sq, s.H, h);
      load_tile<T, BQ, HD>(sdO, dout, b, q0, s.Sq, s.H, h);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < s.Sq;
        sLse[r] = in ? lse[row_base + q0 + r] : 0.f;
        sD[r] = in ? Dg[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[BQ / 16][BK / 16], dp[BQ / 16][BK / 16];
      zero<BQ, BK>(sc);
      zero<BQ, BK>(dp);
      mm_nt<BQ, BK, HD>(sc, sQ, LDH, sK, LDH, ty, tx);
      mm_nt<BQ, BK, HD>(dp, sdO, LDH, sV, LDH, ty, tx);
#pragma unroll
      for (int i = 0; i < BQ / 16; ++i) {
        const int r = ty + 16 * i, qi = q0 + r, qp = qi + s.off;
        const float l = sLse[r], d = sD[r];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const int c = tx + 16 * j, kp = k0 + c;
          const bool valid = qi < s.Sq && kp < s.Sk;
          float p = 0.f, ds = 0.f;
          if (valid && visible(qp, kp, s)) {
            p = expf(sc[i][j] * s.scale - l);
            ds = p * (dp[i][j] - d);
          } else if (valid && row_empty(qp, s)) {
            p = s.inv_sk;
          }
          sP[r * LDP + c] = p;
          sS[r * LDP + c] = ds;
        }
      }
      __syncthreads();
      mm_tn<BK, HD, BQ>(av, sP, LDP, sdO, LDH, ty, tx);
      mm_tn<BK, HD, BQ>(ak, sS, LDP, sQ, LDH, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < BK / 16; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= s.Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * s.Sk + kp) * s.K + kh) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      dk[base + tx + 16 * j] = from_float<T>(ak[i][j] * s.scale);
      dv[base + tx + 16 * j] = from_float<T>(av[i][j]);
    }
  }
}

template <typename KernelT>
int prepare(KernelT kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int HD, int BQ, int BK>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, cudaStream_t st) {
  const size_t bytes = fwd_smem_floats<BQ, BK, HD>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, HD, BQ, BK>;
  if (int rc = prepare(kern, bytes)) return rc;
  dim3 grid((s.Sq + BQ - 1) / BQ, s.B * s.H);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int BQ, int BK>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const float* lse, const void* dout, void* dq, void* dk, void* dv,
        float* Dg, const Shape& s, cudaStream_t st) {
  const size_t dq_bytes = dq_smem_floats<BQ, BK, HD>() * sizeof(float);
  const size_t kv_bytes = dkdv_smem_floats<BQ, BK, HD>() * sizeof(float);
  auto kdq = flash_bwd_dq_kernel<T, HD, BQ, BK>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD, BQ, BK>;
  if (int rc = prepare(kdq, dq_bytes)) return rc;
  if (int rc = prepare(kkv, kv_bytes)) return rc;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kdq<<<dim3((s.Sq + BQ - 1) / BQ, s.B * s.H), kThreads, dq_bytes, st>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, Dg, static_cast<T*>(dq),
      s);
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  kkv<<<dim3((s.Sk + BK - 1) / BK, s.B * s.K), kThreads, kv_bytes, st>>>(
      qt, kt, vt, dot, lse, Dg, static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels (design note at the top of the file)
// ---------------------------------------------------------------------------
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// rows [row0, row0 + ROWS) of head `head` of a (B, S, NH, HD) tensor into a
// swizzled tile, by cp.async; rows past S are zero-filled
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int b,
                                           int row0, int S, int NH,
                                           int head) {
  constexpr int CH = HD / 8;
  static_assert((ROWS * CH) % NT == 0, "tile copy must split evenly");
  const uint32_t base = saddr(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT, r = e / CH, c = e % CH;
    const int s = row0 + r;
    const bool in = s < S;
    const bf16* g =
        src + ((static_cast<size_t>(b) * S + (in ? s : 0)) * NH + head) * HD +
        c * 8;
    cp_async16(base + 2 * swz<HD>(r, c), g, in ? 16 : 0);
  }
}

// src[row0 .. row0 + ROWS) of a float row vector into shared memory; past S
// zero-filled
template <int ROWS, int NT>
__device__ __forceinline__ void vec_async(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const bool in = row0 + r < S;
    cp_async4(saddr(dst + r), src + (in ? row0 + r : 0), in ? 4 : 0);
  }
}

// Whether a (query tile, key tile) pair needs the element mask: it crosses
// the causal diagonal, the window's edge, Sq or Sk. Interior pairs see
// every key.
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            const Shape& s) {
  return q0 + nq > s.Sq || k0 + nk > s.Sk ||
         (s.causal && k0 + nk - 1 > q0 + s.off) ||
         (s.window > 0 && q0 + nq - 1 + s.off - k0 >= s.window);
}

// Tiles per head dim, chosen so that no kernel spills (ptxas -v). Forward:
// BQ queries (a warp per 16) against BK keys, Q's fragments in registers
// when QREG. dQ: BQ queries against DBK keys, Q's and dO's fragments in
// registers when AREG. dK/dV: KBK keys (a warp per 16 and per HD / KHS
// output columns) against KBQ queries, K's and V's fragments in registers
// when KVREG.
template <int HD>
struct Cfg;
template <>
struct Cfg<32> {
  static constexpr int BQ = 64, BK = 64, DBK = 64, KBK = 64, KBQ = 64, KHS = 1;
  static constexpr bool QREG = true, AREG = true, KVREG = true;
};
template <>
struct Cfg<64> {
  static constexpr int BQ = 64, BK = 64, DBK = 64, KBK = 64, KBQ = 64, KHS = 1;
  static constexpr bool QREG = false, AREG = false, KVREG = true;
};
template <>
struct Cfg<128> {
  static constexpr int BQ = 64, BK = 64, DBK = 64, KBK = 64, KBQ = 32, KHS = 1;
  static constexpr bool QREG = true, AREG = false, KVREG = false;
};
template <>
struct Cfg<256> {
  static constexpr int BQ = 64, BK = 32, DBK = 16, KBK = 64, KBQ = 32, KHS = 2;
  static constexpr bool QREG = false, AREG = false, KVREG = false;
};

template <int HD>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(Cfg<HD>::BQ + 4 * Cfg<HD>::BK) * HD * 2;
}
template <int HD>
constexpr size_t dq_smem() {
  return static_cast<size_t>(2 * Cfg<HD>::BQ + 4 * Cfg<HD>::DBK) * HD * 2 +
         2 * Cfg<HD>::BQ * sizeof(float);
}
template <int HD>
constexpr size_t dkdv_smem() {
  return static_cast<size_t>(2 * Cfg<HD>::KBK + 4 * Cfg<HD>::KBQ) * HD * 2 +
         4 * Cfg<HD>::KBQ * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::BQ * 2)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  constexpr int BQ = Cfg<HD>::BQ, BK = Cfg<HD>::BK, NT = BQ * 2;
  constexpr bool QREG = Cfg<HD>::QREG;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = sQ + BQ * HD;        // two stages
  bf16* sV = sK + 2 * BK * HD;    // two stages
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, kh = h / s.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, g = lane >> 2, t = lane & 3;
  const float c = s.scale * kLog2e;
  const int qp0 = q0 + m0 + g + s.off;   // this thread's rows: qp0, qp0 + 8

  int kt_lo, kt_hi;
  if (row_empty(q0 + s.off, s)) {
    kt_lo = 0;   // rows that see no key average V over every key
    kt_hi = (s.Sk + BK - 1) / BK;
  } else {
    key_tiles(q0, BQ, BK, s, &kt_lo, &kt_hi);
  }
  auto load_kv = [&](int kt, int st) {
    tile_async<HD, BK, NT>(sK + st * BK * HD, k, b, kt * BK, s.Sk, s.K, kh);
    tile_async<HD, BK, NT>(sV + st * BK * HD, v, b, kt * BK, s.Sk, s.K, kh);
  };
  tile_async<HD, BQ, NT>(sQ, q, b, q0, s.Sq, s.H, h);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_commit();

  const uint32_t tQ = saddr(sQ);
  uint32_t qf[QREG ? HD / 16 : 1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BK;
    if (kt + 1 < kt_hi) load_kv(kt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if constexpr (QREG) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldsm_a<HD>(qf[kk], tQ, m0, kk, lane);
      }
    }
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    mma_abt<HD, BK, QREG>(sc, qf, tQ, m0, saddr(sK + st * BK * HD), lane);

    // online softmax on the fragments. Masked tiles: x = s * scale in
    // natural units with expf(x - m), the plain version's arithmetic, so a
    // row that sees a few keys (all of them in masked tiles; its lse = m +
    // log l nearly cancels) gets its lse to the last bits. Interior tiles:
    // exp2f with scale * log2 e folded into one multiply-add.
    const bool masked = tile_masked(q0, BQ, k0, BK, s);
    float mx[2] = {-INFINITY, -INFINITY};
    if (masked) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = qp0 + (e >> 1) * 8, kp = k0 + 8 * j + 2 * t + (e & 1);
          float x = sc[j][e] * s.scale;
          if (kp >= s.Sk) x = -INFINITY;
          else if (!visible(qp, kp, s)) x = kMasked;
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e] * s.scale);
    }
    float alpha[2], m2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      m2[i] = m_new * kLog2e;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = masked ? expf(sc[j][e] - m_r[e >> 1])
                               : exp2f(__fmaf_rn(sc[j][e], c, -m2[e >> 1]));
        sc[j][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = __fmaf_rn(alpha[i], l_r[i], ps[i]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    uint32_t pf[BK / 16][4];
    to_a<BK>(pf, sc);
    mma_ab<HD, BK, HD>(acc, pf, saddr(sV + st * BK * HD), 0, lane);
    __syncthreads();   // the next iteration's copy overwrites this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + m0 + g + 8 * i;
    if (qi >= s.Sq) continue;
    bf16* row = o + ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(__fdividef(acc[j][2 * i], l),
                                __fdividef(acc[j][2 * i + 1], l));
    if (t == 0) lse[static_cast<size_t>(bh) * s.Sq + qi] = m_r[i] + logf(l);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::BQ * 2)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ Dg,
                    bf16* __restrict__ dq, Shape s) {
  constexpr int BQ = Cfg<HD>::BQ, BK = Cfg<HD>::DBK, NT = BQ * 2;
  constexpr bool AREG = Cfg<HD>::AREG;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sdO = sQ + BQ * HD;
  bf16* sK = sdO + BQ * HD;       // two stages
  bf16* sV = sK + 2 * BK * HD;    // two stages
  float* sL = reinterpret_cast<float*>(sV + 2 * BK * HD);
  float* sD = sL + BQ;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, kh = h / s.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, g = lane >> 2, t = lane & 3;
  const float c = s.scale * kLog2e;
  const int qp0 = q0 + m0 + g + s.off;

  int kt_lo, kt_hi;   // rows that see no key have dQ 0: no sweep
  key_tiles(q0, BQ, BK, s, &kt_lo, &kt_hi);
  auto load_kv = [&](int kt, int st) {
    tile_async<HD, BK, NT>(sK + st * BK * HD, k, b, kt * BK, s.Sk, s.K, kh);
    tile_async<HD, BK, NT>(sV + st * BK * HD, v, b, kt * BK, s.Sk, s.K, kh);
  };
  tile_async<HD, BQ, NT>(sQ, q, b, q0, s.Sq, s.H, h);
  tile_async<HD, BQ, NT>(sdO, dout, b, q0, s.Sq, s.H, h);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_commit();

  {  // D = rowsum(dO * O) for the tile's rows: CH lanes a row, 16 bytes each
    constexpr int CH = HD / 8;
    static_assert(NT % CH == 0 && CH <= 32, "D: lanes per row");
    const int c8 = threadIdx.x % CH;
#pragma unroll
    for (int i = 0; i < BQ * CH / NT; ++i) {
      const int r = threadIdx.x / CH + i * (NT / CH), qi = q0 + r;
      float d = 0.f;
      if (qi < s.Sq) {
        const size_t at =
            ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD + c8 * 8;
        const uint4 x = *reinterpret_cast<const uint4*>(dout + at);
        const uint4 y = *reinterpret_cast<const uint4*>(o + at);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 fx = __bfloat1622float2(xp[w]);
          const float2 fy = __bfloat1622float2(yp[w]);
          d = __fmaf_rn(fx.x, fy.x, d);
          d = __fmaf_rn(fx.y, fy.y, d);
        }
      }
#pragma unroll
      for (int w = CH / 2; w > 0; w >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, w);
      if (c8 == 0) {
        const bool in = qi < s.Sq;
        const size_t at = static_cast<size_t>(bh) * s.Sq + qi;
        sD[r] = d;
        sL[r] = in ? lse[at] * kLog2e : 0.f;
        if (in) Dg[at] = d;
      }
    }
  }
  __syncthreads();
  float L_r[2], D_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L_r[i] = sL[m0 + g + 8 * i];
    D_r[i] = sD[m0 + g + 8 * i];
  }

  const uint32_t tQ = saddr(sQ), tdO = saddr(sdO);
  uint32_t qf[AREG ? HD / 16 : 1][4], df[AREG ? HD / 16 : 1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BK;
    if (kt + 1 < kt_hi) load_kv(kt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if constexpr (AREG) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          ldsm_a<HD>(qf[kk], tQ, m0, kk, lane);
          ldsm_a<HD>(df[kk], tdO, m0, kk, lane);
        }
      }
    }
    const uint32_t tK = saddr(sK + st * BK * HD);
    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, BK, AREG>(sc, qf, tQ, m0, tK, lane);
    mma_abt<HD, BK, AREG>(dp, df, tdO, m0, saddr(sV + st * BK * HD), lane);
    const bool masked = tile_masked(q0, BQ, k0, BK, s);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(__fmaf_rn(sc[j][e], c, -L_r[i]));
        if (masked) {
          const int qp = qp0 + 8 * i, kp = k0 + 8 * j + 2 * t + (e & 1);
          if (kp >= s.Sk || !visible(qp, kp, s)) p = 0.f;
        }
        sc[j][e] = p * (dp[j][e] - D_r[i]);   // dS
      }
    uint32_t dsf[BK / 16][4];
    to_a<BK>(dsf, sc);
    mma_ab<HD, BK, HD>(acc, dsf, tK, 0, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + m0 + g + 8 * i;
    if (qi >= s.Sq) continue;
    bf16* row = dq + ((static_cast<size_t>(b) * s.Sq + qi) * s.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i] * s.scale,
                                acc[j][2 * i + 1] * s.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::KBK * 2 * Cfg<HD>::KHS)
    flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ Dg, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Shape s) {
  constexpr int BK = Cfg<HD>::KBK, BQ = Cfg<HD>::KBQ, HS = Cfg<HD>::KHS;
  constexpr int NT = BK * 2 * HS, HDO = HD / HS;
  constexpr bool KVREG = Cfg<HD>::KVREG;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + BK * HD;
  bf16* sQ = sV + BK * HD;         // two stages
  bf16* sdO = sQ + 2 * BQ * HD;    // two stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * HD);   // two stages
  float* sD = sL + 2 * BQ;                                   // two stages
  const int bk = blockIdx.y, b = bk / s.K, kh = bk % s.K;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp % (BK / 16)) * 16, n0 = (warp / (BK / 16)) * HDO;
  const int g = lane >> 2, t = lane & 3;
  const float c = s.scale * kLog2e;

  // query rows with a visible key in this tile, and every row that sees no
  // key at all (the first -off rows when causal with Sq > Sk)
  const int k_last = min(k0 + BK, s.Sk) - 1;
  int i_lo = 0, i_hi = s.Sq;
  if (s.causal && s.off >= 0) i_lo = max(0, k0 - s.off);
  if (s.window > 0) i_hi = min(s.Sq, k_last + s.window - s.off);
  const int qt_lo = i_lo / BQ;
  const int nqt = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - qt_lo : 0;
  const int n_it = s.G * nqt;   // (query head of the group, query tile)

  auto load_q = [&](int it, int st) {
    const int h = kh * s.G + it / nqt, q0 = (qt_lo + it % nqt) * BQ;
    const size_t rows = static_cast<size_t>(b * s.H + h) * s.Sq;
    tile_async<HD, BQ, NT>(sQ + st * BQ * HD, q, b, q0, s.Sq, s.H, h);
    tile_async<HD, BQ, NT>(sdO + st * BQ * HD, dout, b, q0, s.Sq, s.H, h);
    vec_async<BQ, NT>(sL + st * BQ, lse + rows, q0, s.Sq);
    vec_async<BQ, NT>(sD + st * BQ, Dg + rows, q0, s.Sq);
  };
  tile_async<HD, BK, NT>(sK, k, b, k0, s.Sk, s.K, kh);
  tile_async<HD, BK, NT>(sV, v, b, k0, s.Sk, s.K, kh);
  if (n_it > 0) load_q(0, 0);
  cp_commit();

  const uint32_t tK = saddr(sK), tV = saddr(sV);
  uint32_t kf[KVREG ? HD / 16 : 1][4], vf[KVREG ? HD / 16 : 1][4];
  float adk[HDO / 8][4], adv[HDO / 8][4];
#pragma unroll
  for (int j = 0; j < HDO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (qt_lo + it % nqt) * BQ;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if constexpr (KVREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          ldsm_a<HD>(kf[kk], tK, m0, kk, lane);
          ldsm_a<HD>(vf[kk], tV, m0, kk, lane);
        }
      }
    }
    const uint32_t tQ = saddr(sQ + st * BQ * HD);
    const uint32_t tdO = saddr(sdO + st * BQ * HD);
    const float* Ls = sL + st * BQ;
    const float* Ds = sD + st * BQ;
    float sc[BQ / 8][4], dp[BQ / 8][4];   // S^T, dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, BQ, KVREG>(sc, kf, tK, m0, tQ, lane);
    mma_abt<HD, BQ, KVREG>(dp, vf, tV, m0, tdO, lane);
    const bool masked = tile_masked(q0, BQ, k0, BK, s);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 L2 = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
      const float2 D2 = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float L = ((e & 1) ? L2.y : L2.x) * kLog2e;
        const float D = (e & 1) ? D2.y : D2.x;
        float p = exp2f(__fmaf_rn(sc[j][e], c, -L));
        float ds = p * (dp[j][e] - D);
        if (masked) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1), qp = qi + s.off;
          const int kp = k0 + m0 + g + 8 * (e >> 1);
          const bool valid = qi < s.Sq && kp < s.Sk;
          if (!(valid && visible(qp, kp, s))) {
            ds = 0.f;
            p = valid && row_empty(qp, s) ? s.inv_sk : 0.f;
          }
        }
        sc[j][e] = p;
        dp[j][e] = ds;
      }
    }
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
    to_a<BQ>(pf, sc);
    to_a<BQ>(dsf, dp);
    mma_ab<HD, BQ, HDO>(adv, pf, tdO, n0, lane);
    mma_ab<HD, BQ, HDO>(adk, dsf, tQ, n0, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + m0 + g + 8 * i;
    if (kp >= s.Sk) continue;
    const size_t base =
        ((static_cast<size_t>(b) * s.Sk + kp) * s.K + kh) * HD + n0;
#pragma unroll
    for (int j = 0; j < HDO / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j + 2 * t) =
          __floats2bfloat162_rn(adk[j][2 * i] * s.scale,
                                adk[j][2 * i + 1] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j + 2 * t) =
          __floats2bfloat162_rn(adv[j][2 * i], adv[j][2 * i + 1]);
    }
  }
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, cudaStream_t st) {
  constexpr size_t bytes = fwd_smem<HD>();
  auto kern = flash_fwd_tc<HD>;
  if (int rc = prepare(kern, bytes)) return rc;
  dim3 grid((s.Sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ, s.B * s.H);
  kern<<<grid, Cfg<HD>::BQ * 2, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const float* lse, const void* dout, void* dq, void* dk, void* dv,
        float* Dg, const Shape& s, cudaStream_t st) {
  using C = Cfg<HD>;
  constexpr size_t dq_bytes = dq_smem<HD>(), kv_bytes = dkdv_smem<HD>();
  auto kdq = flash_bwd_dq_tc<HD>;
  auto kkv = flash_bwd_dkdv_tc<HD>;
  if (int rc = prepare(kdq, dq_bytes)) return rc;
  if (int rc = prepare(kkv, kv_bytes)) return rc;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  kdq<<<dim3((s.Sq + C::BQ - 1) / C::BQ, s.B * s.H), C::BQ * 2, dq_bytes,
        st>>>(qt, kt, vt, static_cast<const bf16*>(o), dot, lse, Dg,
              static_cast<bf16*>(dq), s);
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  kkv<<<dim3((s.Sk + C::KBK - 1) / C::KBK, s.B * s.K), C::KBK * 2 * C::KHS,
        kv_bytes, st>>>(qt, kt, vt, dot, lse, Dg, static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// registers, local (spill) bytes and dynamic shared memory of one kernel
template <int HD>
int info_of(int part, int* out) {
  switch (part) {
    case 0: return info(flash_fwd_tc<HD>, fwd_smem<HD>(), out);
    case 1: return info(flash_bwd_dq_tc<HD>, dq_smem<HD>(), out);
    case 2: return info(flash_bwd_dkdv_tc<HD>, dkdv_smem<HD>(), out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

Shape make_shape(int B, int Sq, int Sk, int H, int K, int causal, int window,
                 float scale) {
  return Shape{B, Sq, Sk, H, K, H / K, Sk - Sq, causal, window, scale,
               1.f / static_cast<float>(Sk)};
}

bool bad_shape(int B, int Sq, int Sk, int H, int K) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0;
}

int fwd_f32(int hd, const void* q, const void* k, const void* v, void* o,
            float* lse, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return fwd<float, 32, 64, 64>(q, k, v, o, lse, s, st);
    case 64: return fwd<float, 64, 64, 64>(q, k, v, o, lse, s, st);
    case 128: return fwd<float, 128, 64, 64>(q, k, v, o, lse, s, st);
    case 256: return fwd<float, 256, 32, 32>(q, k, v, o, lse, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int fwd_bf16(int hd, const void* q, const void* k, const void* v, void* o,
             float* lse, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return tc::fwd<32>(q, k, v, o, lse, s, st);
    case 64: return tc::fwd<64>(q, k, v, o, lse, s, st);
    case 128: return tc::fwd<128>(q, k, v, o, lse, s, st);
    case 256: return tc::fwd<256>(q, k, v, o, lse, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int bwd_f32(int hd, const void* q, const void* k, const void* v,
            const void* o, const float* lse, const void* dout, void* dq,
            void* dk, void* dv, float* Dg, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return bwd<float, 32, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 64: return bwd<float, 64, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 128: return bwd<float, 128, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 256: return bwd<float, 256, 32, 32>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int bwd_bf16(int hd, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dout, void* dq,
             void* dk, void* dv, float* Dg, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return tc::bwd<32>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 64: return tc::bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 128: return tc::bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 256: return tc::bwd<256>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o share it); lse float32 (B, H, Sq)
extern "C" int aqua_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Sk, int H, int K,
                                        int hd, int causal, int window,
                                        float scale, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, K, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return fwd_f32(hd, q, k, v, o, l, s, st);
  if (dtype == 1) return fwd_bf16(hd, q, k, v, o, l, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the dQ kernel (which also writes D, float32 (B, H, Sq) scratch)
// and then the dK/dV kernel on the same stream.
extern "C" int aqua_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv, void* D,
                                        int B, int Sq, int Sk, int H, int K,
                                        int hd, int causal, int window,
                                        float scale, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, K, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* Dg = static_cast<float*>(D);
  if (dtype == 0)
    return bwd_f32(hd, q, k, v, o, l, dout, dq, dk, dv, Dg, s, st);
  if (dtype == 1)
    return bwd_bf16(hd, q, k, v, o, l, dout, dq, dk, dv, Dg, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, local bytes (spills and stack) and dynamic shared memory of the
// bf16 tensor-core kernel `part` (0 forward, 1 dQ, 2 dK/dV) at head dim hd,
// into out[0..2].
extern "C" int aqua_flash_attention_tc_info(int part, int hd, int* out) {
  switch (hd) {
    case 32: return tc::info_of<32>(part, out);
    case 64: return tc::info_of<64>(part, out);
    case 128: return tc::info_of<128>(part, out);
    case 256: return tc::info_of<256>(part, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
