// RWKV-6 WKV recurrence over a key slice of the state, for Hopper (sm_90a).
//
// The partitioned serving step (layers/rwkv6.py, rwkv_time_mix_sharded)
// holds a rank's key rows of every head's state: S in R^{K x V}, K of the
// head's V key dims (rwkv6-3b on pod256: K 4 of 64). Per (sequence b,
// head h), rows i < K, columns j < V:
//
//   y_t[j]  = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- e^{w_t[i]} S[i][j] + k_t[i] v_t[j]            (w_t <= 0)
//
// Every term of y is a sum over the key dims, and row i of S is updated
// from key dim i alone, so the call gives the slice's exact share of y (the
// caller all-reduces the shares over the model axis) and its rows of the
// new state. It replaces the TPU kernel wkv6 (_wkv_kernel) of
// src/repro/kernels/rwkv6_wkv/kernel.py where the reference's partitioner
// splits that kernel's state by key rows; the square kernel (wkv6.cu)
// serves K == V, this one the rectangular slices that kernel does not
// take.
//
// Design: one block per (b, h) and one thread per value column j (V threads,
// 32 or 64), each thread holding its column's K state entries in registers
// (K a template parameter, so the rows unroll). The recurrence walks the
// tokens in order; every kTile tokens the block stages the tile's r, k,
// e^{w} (K values a token each) and v rows (V values) in shared memory
// between two barriers, every load of the tile issued together, so a tile
// waits on global memory once, not once a token (at rwkv6-3b's rank shapes
// 80 blocks of 64 threads: far too few warps to hide a load's latency).
// Each thread writes its y entries straight to global memory. Float32
// throughout with explicit fmaf (the build passes -fmad=false).
//
// Bound: at rwkv6-3b's pod256 rank shapes (K 4, V 64, bf16 r/k/v/y), a
// token moves 2 K + 4 K + 2 V + 2 V bytes a head (r, k in bf16, w in f32,
// v, y in bf16) and does ~5 K V float32 operations, so the bytes set the
// bound; this simple form is latency-bound on the serial token loop
// instead (a dependent chain of K fused multiply-adds a token, a tile's
// loads once a tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                     // tokens staged per barrier
constexpr int kMaxV = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int K>
__global__ void wkv6_keyslice_kernel(const T* __restrict__ r,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const float* __restrict__ w,
                                     const float* __restrict__ u,
                                     const float* __restrict__ s0,
                                     T* __restrict__ y,
                                     float* __restrict__ s_out, int T_len,
                                     int H, int V) {
  __shared__ float sr[kTile][K];
  __shared__ float sk[kTile][K];
  __shared__ float sd[kTile][K];
  __shared__ float sv[kTile][kMaxV];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const long long state0 = static_cast<long long>(bh) * K * V;
  float s[K], uk[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s[i] = s0[state0 + static_cast<long long>(i) * V + j];
    uk[i] = u[h * K + i];
  }
  for (int t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = min(kTile, T_len - t0);
    for (int e = j; e < n * K; e += V) {
      const int t = e / K, i = e % K;
      const long long at =
          ((static_cast<long long>(b) * T_len + t0 + t) * H + h) * K + i;
      sr[t][i] = to_f(r[at]);
      sk[t][i] = to_f(k[at]);
      sd[t][i] = expf(w[at]);
    }
#pragma unroll 16
    for (int t = 0; t < n; ++t) {
      sv[t][j] = to_f(
          v[((static_cast<long long>(b) * T_len + t0 + t) * H + h) * V + j]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const long long row =
          ((static_cast<long long>(b) * T_len + t0 + t) * H + h) * V + j;
      const float vj = sv[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = sk[t][i] * vj;
        acc = fmaf(sr[t][i], fmaf(uk[i], kv, s[i]), acc);
        s[i] = fmaf(sd[t][i], s[i], kv);
      }
      y[row] = from_f<T>(acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    s_out[state0 + static_cast<long long>(i) * V + j] = s[i];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int T_len, int H, int V, cudaStream_t stream) {
  wkv6_keyslice_kernel<T, K><<<B * H, V, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, T_len,
      H, V);
  return static_cast<int>(cudaGetLastError());
}

// f(T{}, std::integral_constant<int, K>) for dtype 0 float32 / 1 bfloat16
// and K a power of two up to 32 (a slice below V; K == V is wkv6.cu's);
// anything else is refused
template <typename F>
int by_type(int dtype, int K, F&& f) {
  auto keys = [&](auto t) -> int {
    switch (K) {
      case 1: return f(t, std::integral_constant<int, 1>());
      case 2: return f(t, std::integral_constant<int, 2>());
      case 4: return f(t, std::integral_constant<int, 4>());
      case 8: return f(t, std::integral_constant<int, 8>());
      case 16: return f(t, std::integral_constant<int, 16>());
      case 32: return f(t, std::integral_constant<int, 32>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (dtype == 0) return keys(float{});
  if (dtype == 1) return keys(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k: (B, T, H, K) and v, y: (B, T, H, V) of the compute dtype (0
// float32, 1 bfloat16); w: (B, T, H, K) float32 log-decay <= 0; u: (H, K)
// float32; s0, s_out: (B, H, K, V) float32 (distinct buffers). V is 32 or
// 64 and K a power of two below it; T >= 1.
extern "C" int aqua_wkv6_keyslice(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* s0, void* y,
                                  void* s_out, int B, int T_len, int H,
                                  int K, int V, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  if ((V != 32 && V != 64) || K >= V || V % K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_type(dtype, K, [&](auto t, auto KC) {
    return launch<decltype(t), decltype(KC)::value>(
        r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(s0), y, static_cast<float*>(s_out), B,
        T_len, H, V, static_cast<cudaStream_t>(stream));
  });
}
