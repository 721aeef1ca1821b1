// The state passes of the key-slice RWKV-6 WKV, shared by its forward
// (csrc/wkv6_keyslice.cu) and its backward (csrc/wkv6_keyslice_bwd.cu).
//
// Per (sequence b, head h) the state is a key slice S in R^{K x V}: rows
// i < K, value columns j < V. The tokens split into chunks of kChunk = 32
// (WKV_CHUNK of kernels/rwkv6_wkv/ref.py; the last may be short). Row i
// of S decays by e^{w_t[i]} a token, so a chunk c acts on the state it
// enters with as
//
//   S_{c+1} = d_c (.) S_c + Delta_c,   d_c[i] = e^{sum_t w_t[i]},
//
// Delta_c the chunk's recurrence S <- e^{w_t} S + k_t v_t^T from a zero
// state, and its exit-state gradient reaches back as
//
//   dS_exit(c - 1) = d_c (.) dS_exit(c) + Gamma_c,
//
// Gamma_c the reverse recurrence dS <- r_t dy_t^T + e^{w_t} dS from zero.
// So the two passes here make every chunk's entry state and exit-state
// gradient for the chunk passes, which then run every chunk at once:
//
//   sums_kernel   a block per (b, h, chunk): d_c, Delta_c and (for the
//                 backward) Gamma_c; a thread per value column holds its
//                 column of every key row, so each staged e^{w}, k and r
//                 value is read once a step for K entries
//   scan_kernel   a thread per (b, h, i, j) entry and direction: walks the
//                 chunks forward (entry states) and, for the backward, in
//                 reverse (exit-state gradients), overwriting each summary
//                 with what it gives;
//                 a summary's load does not wait on the carried value, so
//                 each thread issues kScanAhead chunks' loads together
//
// Blocks of a chunk pass are numbered (b * nt + c) * H + h: the H heads of
// one chunk of tokens run side by side and share the 32-byte sectors of
// their (token, head) rows of r, k, w in L2 (a head's key row is K values,
// 8 bytes at K 4 in bf16). Float32 throughout with explicit fmaf (the
// build passes -fmad=false).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {
namespace ks {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;          // tokens a chunk
constexpr int kScanThreads = 256;
constexpr int kScanAhead = 32;      // chunks a scan thread loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// the chunk of a chunk-pass block
struct Chunk {
  int c, h, n;         // chunk, head, tokens in it
  long long bh;        // b * H + h: the state slice
  long long bhc;       // (b * H + h) * nt + c: the chunk's summary and state
  long long key0;      // element of (b, t0, h, 0) in a (B, T, H, K) tensor
  long long val0;      // and in a (B, T, H, V) tensor
};

template <int K, int V>
__device__ __forceinline__ Chunk chunk_of(int T_len, int H, int nt) {
  Chunk ch;
  const int x = blockIdx.x;
  const int b = x / (H * nt);
  ch.h = x % H;
  ch.c = (x / H) % nt;
  const int t0 = ch.c * kChunk;
  ch.n = min(kChunk, T_len - t0);
  ch.bh = static_cast<long long>(b) * H + ch.h;
  ch.bhc = ch.bh * nt + ch.c;
  const long long row = (static_cast<long long>(b) * T_len + t0) * H + ch.h;
  ch.key0 = row * K;
  ch.val0 = row * V;
  return ch;
}

// A thread's share of a chunk's rows of a (B, T, H, V) tensor, staged in
// 16-byte pieces: load() issues every global load of the share before
// store() writes any of it to shared memory (as S: float, or T itself),
// so a thread waits on global memory once, not once a piece.
template <typename T, int V, int NT>
struct ValueRows {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPer = V / kVec;
  static constexpr int kLoads = (kChunk * kPer + NT - 1) / NT;
  uint4 x[kLoads];

  __device__ __forceinline__ void load(const T* src, const Chunk& ch, int H,
                                       int tid) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int at = tid + e * NT;
      if (at < ch.n * kPer)
        x[e] = *reinterpret_cast<const uint4*>(
            src + ch.val0 + static_cast<long long>(at / kPer) * H * V +
            at % kPer * kVec);
    }
  }

  // a piece's kVec values as float
  __device__ __forceinline__ static void unpack(const uint4& p,
                                                float (&f)[kVec]) {
    const uint32_t u[4] = {p.x, p.y, p.z, p.w};
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int m = 0; m < 4; ++m) f[m] = __uint_as_float(u[m]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        f[2 * m] = __uint_as_float(u[m] << 16);
        f[2 * m + 1] = __uint_as_float(u[m] & 0xffff0000u);
      }
    }
  }

  // sum of the products of piece e's values with o's (the same rows of
  // another tensor), 0 for a piece past the chunk's tokens
  __device__ __forceinline__ float dot(const ValueRows& o, const Chunk& ch,
                                       int tid, int e) const {
    if (tid + e * NT >= ch.n * kPer) return 0.f;
    float f[kVec], g[kVec];
    unpack(x[e], f);
    unpack(o.x[e], g);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kVec; ++m) acc = fmaf(f[m], g[m], acc);
    return acc;
  }

  template <typename S>
  __device__ __forceinline__ void store(S (*dst)[V], const Chunk& ch,
                                        int tid) const {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int at = tid + e * NT;
      if (at >= ch.n * kPer) continue;
      S* out = &dst[at / kPer][at % kPer * kVec];
      if constexpr (std::is_same_v<S, T>) {
        *reinterpret_cast<uint4*>(out) = x[e];
      } else {
        static_assert(std::is_same_v<S, float>, "rows staged as float");
        float f[kVec];
        unpack(x[e], f);
#pragma unroll
        for (int m = 0; m < kVec; m += 4)
          reinterpret_cast<float4*>(out)[m / 4] =
              make_float4(f[m], f[m + 1], f[m + 2], f[m + 3]);
      }
    }
  }
};

// The same for a chunk's rows of a (B, T, H, K) tensor, a value a load,
// held as float
template <int K, int NT>
struct KeyRows {
  static constexpr int kLoads = (kChunk * K + NT - 1) / NT;
  float x[kLoads];

  template <typename T>
  __device__ __forceinline__ void load(const T* src, const Chunk& ch, int H,
                                       int tid) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int at = tid + e * NT;
      if (at < ch.n * K)
        x[e] = to_f(src[ch.key0 + static_cast<long long>(at / K) * H * K +
                        at % K]);
    }
  }

  // dst[t][i] = f(value)
  template <typename F>
  __device__ __forceinline__ void store(float (*dst)[K], const Chunk& ch,
                                        int tid, F&& f) const {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int at = tid + e * NT;
      if (at < ch.n * K) dst[at / K][at % K] = f(x[e]);
    }
  }
  __device__ __forceinline__ void store(float (*dst)[K], const Chunk& ch,
                                        int tid) const {
    store(dst, ch, tid, [](float y) { return y; });
  }
};

__device__ __forceinline__ float exp_of(float x) { return expf(x); }

// -- pass 1: each chunk's summaries ------------------------------------------
// d: (B, H, nt, K); delta and, with kGamma, gamma: (B, H, nt, K, V),
// float32. V threads a summary (with kGamma, the first V walk Delta
// forward, the others Gamma back), thread j's column of every key row in
// registers.
template <typename T, int K, int V, bool kGamma>
__global__ void __launch_bounds__((1 + kGamma) * V)
    sums_kernel(const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ r,
                const T* __restrict__ dy, float* __restrict__ d,
                float* __restrict__ delta, float* __restrict__ gamma,
                int T_len, int H, int nt) {
  constexpr int NT = (1 + kGamma) * V;
  constexpr int KR = kGamma ? K : 1;
  constexpr int VR = kGamma ? V : 1;
  __shared__ __align__(16) float sw[kChunk][K];
  __shared__ __align__(16) float sd[kChunk][K];
  __shared__ __align__(16) float sk[kChunk][K];
  __shared__ __align__(16) float sr[kChunk][KR];
  __shared__ __align__(16) float sv[kChunk][V];
  __shared__ __align__(16) float sdy[kChunk][VR];
  const Chunk ch = chunk_of<K, V>(T_len, H, nt);
  const int tid = threadIdx.x;
  KeyRows<K, NT> ww, kk, rr;
  ValueRows<T, V, NT> vv, yy;
  ww.load(w, ch, H, tid);
  kk.load(k, ch, H, tid);
  vv.load(v, ch, H, tid);
  if constexpr (kGamma) {
    rr.load(r, ch, H, tid);
    yy.load(dy, ch, H, tid);
  }
  ww.store(sw, ch, tid);
  ww.store(sd, ch, tid, exp_of);
  kk.store(sk, ch, tid);
  vv.store(sv, ch, tid);
  if constexpr (kGamma) {
    rr.store(sr, ch, tid);
    yy.store(sdy, ch, tid);
  }
  __syncthreads();
  if (tid < K) {
    float lw = 0.f;
    for (int t = 0; t < ch.n; ++t) lw += sw[t][tid];
    d[ch.bhc * K + tid] = expf(lw);
  }
  const long long out0 = ch.bhc * K * V;
  if (tid < V) {
    const int j = tid;
    float s[K];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int t = 0; t < ch.n; ++t) {
      const float vj = sv[t][j];
#pragma unroll
      for (int i = 0; i < K; ++i)
        s[i] = fmaf(sd[t][i], s[i], sk[t][i] * vj);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) delta[out0 + i * V + j] = s[i];
  } else if constexpr (kGamma) {
    const int j = tid - V;
    float g[K];
#pragma unroll
    for (int i = 0; i < K; ++i) g[i] = 0.f;
#pragma unroll 4
    for (int t = ch.n - 1; t >= 0; --t) {
      const float dj = sdy[t][j];
#pragma unroll
      for (int i = 0; i < K; ++i)
        g[i] = fmaf(sd[t][i], g[i], sr[t][i] * dj);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) gamma[out0 + i * V + j] = g[i];
  }
}

// -- pass 2: the scan over the chunks ----------------------------------------
// A thread per (b, h, i, j) of B * H * K * V entries and direction.
// Forward (blockIdx.y 0): states holds Delta_c on entry and each chunk's
// entry state on exit, from s0. Reverse (blockIdx.y 1, run when dstates is
// not null): dstates holds Gamma_c on entry and each chunk's exit-state
// gradient on exit, from ds_out; ds_in gets the initial state's gradient.
// The final state is the chunk pass's to write.
template <int K, int V>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const float* __restrict__ d, const float* __restrict__ s0,
                float* states, const float* __restrict__ ds_out,
                float* dstates, float* __restrict__ ds_in,
                long long entries, int nt) {
  constexpr int KV = K * V;
  const long long e =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (e >= entries) return;
  const bool reverse = blockIdx.y == 1;
  const long long bh = e / KV;
  const int ij = static_cast<int>(e % KV);
  const float* dd = d + bh * nt * K + ij / V;
  float* buf = (reverse ? dstates : states) + bh * nt * KV + ij;
  float s = reverse ? ds_out[e] : s0[e];
  for (int c0 = 0; c0 < nt; c0 += kScanAhead) {
    float x[kScanAhead], f[kScanAhead];
#pragma unroll
    for (int q = 0; q < kScanAhead; ++q) {
      const int c = reverse ? nt - 1 - (c0 + q) : c0 + q;
      x[q] = f[q] = 0.f;
      if (c0 + q < nt) {
        x[q] = buf[static_cast<long long>(c) * KV];
        f[q] = dd[static_cast<long long>(c) * K];
      }
    }
#pragma unroll
    for (int q = 0; q < kScanAhead; ++q) {
      const int c = reverse ? nt - 1 - (c0 + q) : c0 + q;
      if (c0 + q < nt) {
        buf[static_cast<long long>(c) * KV] = s;
        s = fmaf(f[q], s, x[q]);
      }
    }
  }
  if (reverse) ds_in[e] = s;
}

template <int K, int V>
int launch_scan(const float* d, const float* s0, float* states,
                const float* ds_out, float* dstates, float* ds_in, int B,
                int H, int nt, cudaStream_t stream) {
  const long long entries = static_cast<long long>(B) * H * K * V;
  const dim3 grid(static_cast<unsigned>((entries + kScanThreads - 1) /
                                        kScanThreads),
                  dstates != nullptr ? 2 : 1);
  scan_kernel<K, V><<<grid, kScanThreads, 0, stream>>>(
      d, s0, states, ds_out, dstates, ds_in, entries, nt);
  return static_cast<int>(cudaGetLastError());
}

// registers, local bytes (spills and stack), shared memory (static +
// dynamic) and resident blocks per SM of a kernel into out[0..3]
template <typename KernelT>
int info(KernelT kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  if (int rc = static_cast<int>(cudaFuncGetAttributes(&a, kernel))) return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + dyn_smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], kernel, threads, dyn_smem));
}

}  // namespace ks
}  // namespace
