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
// 8.6e10 FLOP (87 us) and 134 MB (40 us). Both are bound by operations.
//
// Design, simple first: float32 CUDA-core FMAs (explicit fmaf: the library
// builds with -fmad=false), tiles staged in shared memory as float with
// rows padded to hd + 1 floats, 256 threads laid out 16 x 16, each holding a
// register micro-tile of every product (rows ty + 16 i, columns tx + 16 j;
// the padding keeps the 16 distinct rows a warp reads in 16 banks).
//  - forward: one block per (b h, query tile); a loop over key tiles stands
//    in for the TPU grid's sequential ik axis, and registers and shared
//    memory for its VMEM scratch acc/m/l. Heavy (late) causal tiles start
//    first.
//  - dQ: one block per (b h, query tile) over key tiles; it also computes D
//    for its rows and writes it for the dK/dV kernel, launched after it.
//  - dK, dV: one block per (b kv-head, key tile), looping over the G query
//    heads of the group and the query tiles, so the group sum stays in
//    registers: no atomics, a deterministic result.
// Tiles fully masked by causality or the window are skipped in index space
// (a query tile with rows that see no key sweeps every key tile in the
// forward; their dQ is 0 and the dK/dV kernel keeps them in its range).
// Tiles: 64 x 64 for hd <= 128, 32 x 32 at hd 256 (shared memory <= 166 KB).
// Tensor cores (mma / wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr float kMasked = -1e30f;

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
  return __float2bfloat16_rn(x);
}

struct Shape {
  int B, Sq, Sk, H, K, G, off;   // off = Sk - Sq
  int causal, window;
  float scale;
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
  const float inv_sk = 1.f / static_cast<float>(s.Sk);

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
            p = inv_sk;
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

Shape make_shape(int B, int Sq, int Sk, int H, int K, int causal, int window,
                 float scale) {
  return Shape{B, Sq, Sk, H, K, H / K, Sk - Sq, causal, window, scale};
}

bool bad_shape(int B, int Sq, int Sk, int H, int K) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0;
}

template <typename T>
int fwd_by_hd(int hd, const void* q, const void* k, const void* v, void* o,
              float* lse, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return fwd<T, 32, 64, 64>(q, k, v, o, lse, s, st);
    case 64: return fwd<T, 64, 64, 64>(q, k, v, o, lse, s, st);
    case 128: return fwd<T, 128, 64, 64>(q, k, v, o, lse, s, st);
    case 256: return fwd<T, 256, 32, 32>(q, k, v, o, lse, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_by_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const float* lse, const void* dout, void* dq,
              void* dk, void* dv, float* Dg, const Shape& s, cudaStream_t st) {
  switch (hd) {
    case 32: return bwd<T, 32, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 64: return bwd<T, 64, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 128: return bwd<T, 128, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
    case 256: return bwd<T, 256, 32, 32>(q, k, v, o, lse, dout, dq, dk, dv, Dg, s, st);
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
  if (dtype == 0) return fwd_by_hd<float>(hd, q, k, v, o, l, s, st);
  if (dtype == 1) return fwd_by_hd<__nv_bfloat16>(hd, q, k, v, o, l, s, st);
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
    return bwd_by_hd<float>(hd, q, k, v, o, l, dout, dq, dk, dv, Dg, s, st);
  if (dtype == 1)
    return bwd_by_hd<__nv_bfloat16>(hd, q, k, v, o, l, dout, dq, dk, dv, Dg,
                                    s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
