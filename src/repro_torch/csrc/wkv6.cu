// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6 (_wkv_kernel) of
// src/repro/kernels/rwkv6_wkv/kernel.py. Per (sequence b, head h), with
// state S in R^{hd x hd} (rows: key dims i, columns: value dims j):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T                 (w_t <= 0)
//
// computed in chunks of C = 32 tokens, as the TPU kernel does:
//
//   lw      = cumsum(w) within the chunk (inclusive); lw_prev[t] = lw[t-1]
//   y_cross = (r * e^{lw_prev}) @ S
//   A[t,tau] = sum_i r_t[i] k_tau[i] e^{lw_prev[t,i] - lw[tau,i]}   (tau < t)
//   A[t,t]   = sum_i r_t[i] u[i] k_t[i]
//   y        = y_cross + A @ v
//   S'       = e^{lw_last} * S + (k * e^{lw_last - lw})^T @ v
//
// Every exponent is <= 0: A is built from the PAIRWISE difference
// lw_prev[t] - lw[tau], never from e^{lw} * e^{-lw}, which overflows for
// strong decays. Unlike the TPU kernel, T need not be a multiple of C: the
// last chunk may be short (the engine launches T = 1 for decode lanes and
// the chunk buckets 8..256).
//
// Bound: at the engine's chunk shape (B 8, T 256, H 40, hd 64, bf16 r/k/v/y,
// f32 w and state) the call must move ~73 MB (r, k, v, y 2 bytes each, w 4,
// the state read and written once in f32), ~22 us at 3.35 TB/s. The chunked
// algorithm does ~1.7e9 f32 operations (~25 us at 67 TFLOP/s) and ~9.2e7
// exponentials on the causal pairs (~22 us on the 16 special-function units
// of each SM at the 1.98 GHz boost clock). The three are within 15% of each
// other, so the operations set the bound only just; at T = 1 (decode) the
// state's bytes set it.
//
// Design, simple first: one block of 256 threads per (b, h) holds S in
// shared memory (16 KB at hd 64) and walks the chunks in order (the TPU's
// sequential grid axis becomes the loop). Per chunk: the r, k, v, w rows
// are staged in shared memory as float; 64 threads take the cumulative sums;
// each warp builds rows of A with lane = tau (k and lw rows padded to hd + 1
// floats so the lanes hit 32 different banks); each thread owns one value
// column j of several output rows and then of several state rows, so S and
// v are read once per step and shared across the rows it holds. All
// arithmetic is float32 with explicit fmaf; exponentials are __expf
// (ex2.approx; relative error ~1e-7 * |x|, far inside the 1e-3 tolerance
// the kernel is held to). Tensor cores (the three products are
// (C,hd)x(hd,hd), (C,C)x(C,hd) and (hd,C)x(C,hd) per chunk) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr int smem_floats() {
  // S, r, r*e^{lw_prev}, v, k (padded), lw (padded), A, u, e^{lw_last}
  return HD * HD + 3 * kChunk * HD + 2 * kChunk * (HD + 1) +
         kChunk * kChunk + 2 * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int T_len, int H) {
  constexpr int LD = HD + 1;                // padded row stride of k and lw
  constexpr int G = kThreads / HD;          // thread groups over columns
  constexpr int YROWS = kChunk / G;         // output rows per thread
  constexpr int SROWS = HD / G;             // state rows per thread
  extern __shared__ float smem[];
  float* S = smem;
  float* rs = S + HD * HD;
  float* rq = rs + kChunk * HD;
  float* vs = rq + kChunk * HD;
  float* ks = vs + kChunk * HD;
  float* lw = ks + kChunk * LD;
  float* A = lw + kChunk * LD;
  float* us = A + kChunk * kChunk;
  float* decay = us + HD;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const long long state_off = static_cast<long long>(bh) * HD * HD;
  for (int e = tid; e < HD * HD; e += kThreads) S[e] = s0[state_off + e];
  if (tid < HD) us[tid] = u[static_cast<long long>(h) * HD + tid];

  const int j = tid % HD;                   // this thread's value column
  const int grp = tid / HD;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int cn = min(kChunk, T_len - t0);
    // -- stage the chunk's rows as float ------------------------------------
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      const long long g =
          (static_cast<long long>(b) * T_len + t0 + t) * H * HD +
          static_cast<long long>(h) * HD + i;
      rs[t * HD + i] = to_float(r[g]);
      vs[t * HD + i] = to_float(v[g]);
      ks[t * LD + i] = to_float(k[g]);
      lw[t * LD + i] = w[g];
    }
    __syncthreads();
    // -- inclusive cumulative log-decay per key dim -------------------------
    if (tid < HD) {
      float acc = 0.f;
      for (int t = 0; t < cn; ++t) {
        acc += lw[t * LD + tid];
        lw[t * LD + tid] = acc;
      }
      decay[tid] = __expf(acc);
    }
    __syncthreads();
    // -- r * e^{lw_prev}; the pairwise intra-chunk matrix A -----------------
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      rq[t * HD + i] =
          t == 0 ? rs[i] : rs[t * HD + i] * __expf(lw[(t - 1) * LD + i]);
    }
    for (int t = warp; t < cn; t += kThreads / 32) {
      const int tau = lane;                 // kChunk == warp size
      if (tau > t) continue;
      float acc = 0.f;
      if (tau == t) {
        for (int i = 0; i < HD; ++i)
          acc = fmaf(rs[t * HD + i] * us[i], ks[t * LD + i], acc);
      } else {
        for (int i = 0; i < HD; ++i)
          acc = fmaf(rs[t * HD + i] * ks[tau * LD + i],
                     __expf(lw[(t - 1) * LD + i] - lw[tau * LD + i]), acc);
      }
      A[t * kChunk + tau] = acc;
    }
    __syncthreads();
    // -- outputs: y[t, j] = sum_i rq[t, i] S[i, j] + sum_{tau<=t} A v -------
    {
      float acc[YROWS];
#pragma unroll
      for (int q = 0; q < YROWS; ++q) acc[q] = 0.f;
      for (int i = 0; i < HD; ++i) {
        const float s = S[i * HD + j];
#pragma unroll
        for (int q = 0; q < YROWS; ++q)
          acc[q] = fmaf(rq[(grp + q * G) * HD + i], s, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < YROWS; ++q) {
        const int t = grp + q * G;
        if (t >= cn) break;
        float a = acc[q];
        for (int tau = 0; tau <= t; ++tau)
          a = fmaf(A[t * kChunk + tau], vs[tau * HD + j], a);
        const long long g =
            (static_cast<long long>(b) * T_len + t0 + t) * H * HD +
            static_cast<long long>(h) * HD + j;
        y[g] = from_float<T>(a);
      }
    }
    // k * e^{lw_last - lw}, in place (A is built; y does not read k)
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      ks[t * LD + i] *= __expf(lw[(cn - 1) * LD + i] - lw[t * LD + i]);
    }
    __syncthreads();
    // -- state: S[i, j] = e^{lw_last[i]} S[i, j] + sum_t k_tail[t, i] v[t, j]
    {
      float acc[SROWS];
#pragma unroll
      for (int q = 0; q < SROWS; ++q) {
        const int i = grp + q * G;
        acc[q] = decay[i] * S[i * HD + j];
      }
      for (int t = 0; t < cn; ++t) {
        const float vv = vs[t * HD + j];
#pragma unroll
        for (int q = 0; q < SROWS; ++q)
          acc[q] = fmaf(ks[t * LD + grp + q * G], vv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < SROWS; ++q) S[(grp + q * G) * HD + j] = acc[q];
    }
    __syncthreads();
  }
  for (int e = tid; e < HD * HD; e += kThreads) s_out[state_off + e] = S[e];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int T_len, int H, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T, HD><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, T_len,
      H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, void* y, float* s_out, int B,
                int T_len, int H, int hd, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
  if (hd == 32)
    return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v, y: (B, T, H, hd) of the compute dtype (0 float32, 1 bfloat16);
// w: (B, T, H, hd) float32 log-decay <= 0; u: (H, hd) float32; s0, s_out:
// (B, H, hd, hd) float32 (distinct buffers). hd is 32 or 64; T >= 1.
extern "C" int aqua_wkv6(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s_out, int B, int T_len, int H,
                         int hd, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0)
    return by_head_dim<float>(r, k, v, wf, uf, sf, y, so, B, T_len, H, hd, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(r, k, v, wf, uf, sf, y, so, B, T_len, H,
                                      hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
