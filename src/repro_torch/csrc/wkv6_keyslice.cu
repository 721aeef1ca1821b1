// RWKV-6 WKV recurrence over a key slice of the state, for Hopper (sm_90a).
//
// The partitioned serving and train steps (layers/rwkv6.py,
// rwkv_time_mix_sharded, rwkv_train_sharded) hold a rank's key rows of
// every head's state: S in R^{K x V}, K of the head's V key dims
// (rwkv6-3b on pod256: K 4 of 64). Per (sequence b, head h), rows i < K,
// columns j < V:
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
// Design: the tokens split into chunks of 32 (the last may be short), and
// every chunk runs at once, as three launches (csrc/wkv6_keyslice.cuh has
// the first two, which the backward shares):
//   1. sums_kernel: each chunk's decay d_c and its recurrence Delta_c from
//      a zero state;
//   2. scan_kernel: a thread per state entry walks the chunks, S_{c+1} =
//      d_c S_c + Delta_c, writing each chunk's entry state over Delta_c;
//   3. fwd_chunk_kernel: a block per (b, h, chunk), a thread per value
//      column holding its column's K state entries from the chunk's entry
//      state, walks the chunk's tokens and writes y; the last chunk's
//      block writes the new state.
// A call of at most 32 tokens is pass 3 alone from the initial state. A
// token's step waits on the one before it only within its chunk, so the
// chunks give ~20,000 blocks at rwkv6-3b's train micro-batch, where a
// block per (b, h) would give 160. Each block issues its global loads
// before its first shared store.
//
// Bound: at rwkv6-3b's pod256 rank shapes (K 4, V 64, bf16 r/k/v/y), a
// token moves 2 K + 4 K + 2 V + 2 V bytes a head (r, k in bf16, w in f32,
// v, y in bf16) and does ~5 K V float32 operations, so the bytes set the
// bound. This design reads k, w and v twice (passes 1 and 3) and writes
// and reads the chunk states (K V floats a chunk, twice), ~570 bytes a
// token-head against the bound's 288. Float32 throughout with explicit
// fmaf (the build passes -fmad=false).
#include "wkv6_keyslice.cuh"

namespace {

using ks::bf16;
using ks::kChunk;

// -- pass 3: y of every chunk from its entry state ---------------------------
// states: (B, H, nt, K, V) float32, each chunk's entry state (s0 itself when
// nt == 1); s_out (when not null) gets the last chunk's exit state.
template <typename T, int K, int V>
__global__ void __launch_bounds__(V)
    fwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ states, T* __restrict__ y,
                     float* __restrict__ s_out, int T_len, int H, int nt) {
  __shared__ __align__(16) float sr[kChunk][K];
  __shared__ __align__(16) float sk[kChunk][K];
  __shared__ __align__(16) float sd[kChunk][K];
  __shared__ __align__(16) float sv[kChunk][V];
  const ks::Chunk ch = ks::chunk_of<K, V>(T_len, H, nt);
  const int j = threadIdx.x;
  ks::KeyRows<K, V> rr, kk, ww;
  ks::ValueRows<T, V, V> vv;
  rr.load(r, ch, H, j);
  kk.load(k, ch, H, j);
  ww.load(w, ch, H, j);
  vv.load(v, ch, H, j);
  float s[K], uk[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s[i] = states[(ch.bhc * K + i) * V + j];
    uk[i] = u[ch.h * K + i];
  }
  rr.store(sr, ch, j);
  kk.store(sk, ch, j);
  ww.store(sd, ch, j, ks::exp_of);
  vv.store(sv, ch, j);
  __syncthreads();
  T* yj = y + ch.val0 + j;
#pragma unroll 4
  for (int t = 0; t < ch.n; ++t) {
    const float vj = sv[t][j];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float kv = sk[t][i] * vj;
      acc = fmaf(sr[t][i], fmaf(uk[i], kv, s[i]), acc);
      s[i] = fmaf(sd[t][i], s[i], kv);
    }
    yj[static_cast<long long>(t) * H * V] = ks::from_f<T>(acc);
  }
  if (s_out != nullptr && ch.c == nt - 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) s_out[(ch.bh * K + i) * V + j] = s[i];
  }
}

// f(T{}, K, V as integral constants) for dtype 0 float32 / 1 bfloat16, V 32
// or 64 and K a power of two up to 32 below V (K == V is wkv6.cu's);
// anything else is refused
template <typename F>
int by_type(int dtype, int K, int V, F&& f) {
  auto values = [&](auto t, auto KC) -> int {
    if (V == 32) return f(t, KC, std::integral_constant<int, 32>());
    if (V == 64) return f(t, KC, std::integral_constant<int, 64>());
    return static_cast<int>(cudaErrorInvalidValue);
  };
  auto keys = [&](auto t) -> int {
    switch (K) {
      case 1: return values(t, std::integral_constant<int, 1>());
      case 2: return values(t, std::integral_constant<int, 2>());
      case 4: return values(t, std::integral_constant<int, 4>());
      case 8: return values(t, std::integral_constant<int, 8>());
      case 16: return values(t, std::integral_constant<int, 16>());
      case 32: return values(t, std::integral_constant<int, 32>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (K >= V) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return keys(float{});
  if (dtype == 1) return keys(bf16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k: (B, T, H, K) and v, y: (B, T, H, V) of the compute dtype (0
// float32, 1 bfloat16); w: (B, T, H, K) float32 log-decay <= 0; u: (H, K)
// float32; s0, s_out: (B, H, K, V) float32; d: (B, H, nt, K) and states:
// (B, H, nt, K, V) float32 scratch, nt = ceil(T / 32). passes: bit 0 runs
// pass 1 (k, v, w -> d, Delta into states), bit 1 pass 2 (d, states, s0 ->
// each chunk's entry state in states), bit 2 pass 3 (r, k, v, w, u, states
// -> y, and the last chunk's exit state, the final state, into s_out when
// it is not null); a pass not run may get null for what only it touches.
// With nt == 1 pass 3 alone may take s0 as states. v and y start on a
// 16-byte boundary. V is 32 or 64 and K a power of two below it; T >= 1.
// Returns the first launch's error.
extern "C" int aqua_wkv6_keyslice(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* s0, void* y,
                                  void* s_out, void* d, void* states,
                                  int B, int T_len, int H, int K, int V,
                                  int dtype, int passes, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    using T = decltype(t);
    constexpr int KK = decltype(KC)::value, VV = decltype(VC)::value;
    const auto st = static_cast<cudaStream_t>(stream);
    const int nt = (T_len + kChunk - 1) / kChunk;
    const int blocks = B * H * nt;
    if (passes & 1) {
      ks::sums_kernel<T, KK, VV, false><<<blocks, VV, 0, st>>>(
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(w), nullptr, nullptr,
          static_cast<float*>(d), static_cast<float*>(states), nullptr,
          T_len, H, nt);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    if (passes & 2) {
      if (int rc = ks::launch_scan<KK, VV>(
              static_cast<const float*>(d), static_cast<const float*>(s0),
              static_cast<float*>(states), nullptr, nullptr, nullptr, B,
              H, nt, st))
        return rc;
    }
    if (passes & 4) {
      fwd_chunk_kernel<T, KK, VV><<<blocks, VV, 0, st>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<const float*>(states),
          static_cast<T*>(y), static_cast<float*>(s_out), T_len, H, nt);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    return 0;
  });
}

// out[0..11]: per pass (sums, scan, chunk) the registers, local bytes
// (spills and stack), shared memory and resident blocks per SM of its
// kernel for (dtype, K, V)
extern "C" int aqua_wkv6_keyslice_info(int dtype, int K, int V, int* out) {
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    using T = decltype(t);
    constexpr int KK = decltype(KC)::value, VV = decltype(VC)::value;
    if (int rc = ks::info(ks::sums_kernel<T, KK, VV, false>, VV, 0, out))
      return rc;
    if (int rc = ks::info(ks::scan_kernel<KK, VV>, ks::kScanThreads, 0,
                          out + 4))
      return rc;
    return ks::info(fwd_chunk_kernel<T, KK, VV>, VV, 0, out + 8);
  });
}
