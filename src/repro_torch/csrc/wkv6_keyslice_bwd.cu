// The backward of the RWKV-6 WKV recurrence over a key slice of the state,
// for Hopper (sm_90a).
//
// The partitioned train step (layers/rwkv6.py, rwkv_time_mix_sharded)
// holds a rank's key rows of every head's state: S in R^{K x V}, K of the
// head's V key dims (rwkv6-3b on pod256: K 4 of 64). The forward is
// wkv6_keyslice.cu. Per (sequence b, head h), rows i < K, columns j < V,
// with dS_t the gradient of the state after token t (dS_T = ds_out):
//
//   dr_t[i]      = sum_j dy_t[j] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   dk_t[i]      = sum_j dS_t[i][j] v_t[j] + r_t[i] u[i] (dy_t . v_t)
//   dw_t[i]      = e^{w_t[i]} sum_j S_{t-1}[i][j] dS_t[i][j]
//   du[i]       += r_t[i] k_t[i] (dy_t . v_t)
//   dv_t[j]      = sum_i (dS_t[i][j] k_t[i] + r_t[i] u[i] k_t[i] dy_t[j])
//   dS_{t-1}[i][j] = r_t[i] dy_t[j] + e^{w_t[i]} dS_t[i][j]
//
// dr, dk, dw and du are the slice's rows of the whole state's; dv is the
// slice's share of the whole's dv (the caller sums the shares over the
// model axis). Replaces no TPU kernel: the reference differentiates its
// jnp wkv6_chunked under GSPMD, where its partitioner splits the state of
// wkv6 (src/repro/kernels/rwkv6_wkv/kernel.py) by key rows, as the forward
// wkv6_keyslice.cu replaces that kernel's. The square backward
// (wkv6_bwd.cu) serves K == V, this one the rectangular slices it does not
// take.
//
// Design: one warp per (b, h); lane l owns the value columns l and l + 32
// (V / 32 of them), holding its columns' K state entries in registers (K
// and V template parameters, so every loop over them unrolls). The states
// S_{t-1} are needed in reverse order, so:
//   1. a forward pass over the tokens writes the state at the start of
//      every tile of NT tokens to a scratch buffer;
//   2. a reverse pass walks the tiles from the last: it stages the tile's
//      r, k, e^{w} (K values a token), v and dy (V) in shared memory,
//      recomputes the tile's states from its entry state into shared
//      memory (each lane its own columns), then walks the tile's tokens in
//      reverse, carrying dS in registers. The sums over j (dr, dk, dw, and
//      dy . v) are per-lane partial sums reduced across the warp with
//      butterfly shuffles; lane 0 keeps the tile's dr, dk, dw in shared
//      memory, written to global memory once a tile, and du.
// NT is the most tokens whose states and rows fit 32 KiB of static
// shared memory. Float32 throughout with explicit fmaf (the build passes
// -fmad=false).
//
// Bound: at rwkv6-3b's pod256 rank shapes (K 4, V 64, bf16 r/k/v/dy), a
// token moves r, k, dr, dk (2 K bytes each), w and dw (4 K), v, dy and dv
// (2 V) a head: 448 bytes, against ~14 K V float32 operations, so the
// bytes set the bound. This simple form is latency-bound instead: few
// warps, a serial token loop, and the shuffles of each token's sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;

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

// tokens a tile: the states (K V floats a token), the staged r, k, e^w,
// v, dy and the kept dr, dk, dw (6 K + 2 V) within 8,192 floats
__host__ __device__ constexpr int tile_tokens(int K, int V) {
  const int n = 8192 / (K * V + 6 * K + 2 * V);
  return n < 1 ? 1 : (n > 64 ? 64 : n);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(kWarp)
    wkv6_keyslice_bwd_kernel(const T* __restrict__ r,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ w,
                             const float* __restrict__ u,
                             const float* __restrict__ s0,
                             const T* __restrict__ dy,
                             const float* __restrict__ ds_out,
                             T* __restrict__ dr, T* __restrict__ dk,
                             T* __restrict__ dv, float* __restrict__ dw,
                             float* __restrict__ du_part,
                             float* __restrict__ ds_in,
                             float* __restrict__ ckpt, int T_len, int H) {
  constexpr int NT = tile_tokens(K, V);
  constexpr int CV = V / kWarp;
  __shared__ float ss[NT][K][V];            // S_{t-1} of the tile's tokens
  __shared__ float sr[NT][K], sk[NT][K], sd[NT][K];
  __shared__ float sv[NT][V], sdy[NT][V];
  __shared__ float odr[NT][K], odk[NT][K], odw[NT][K];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x;
  const int n_tiles = (T_len + NT - 1) / NT;
  const long long state0 = static_cast<long long>(bh) * K * V;
  float* ck = ckpt + static_cast<long long>(bh) * n_tiles * K * V;
  auto key_at = [&](int t, int i) {
    return ((static_cast<long long>(b) * T_len + t) * H + h) * K + i;
  };
  auto val_at = [&](int t, int j) {
    return ((static_cast<long long>(b) * T_len + t) * H + h) * V + j;
  };
  float uk[K];
#pragma unroll
  for (int i = 0; i < K; ++i) uk[i] = u[h * K + i];

  // 1. forward: the entry state of every tile
  float s[K][CV];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c)
      s[i][c] = s0[state0 + i * V + lane + kWarp * c];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * NT, n = min(NT, T_len - t0);
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int c = 0; c < CV; ++c)
        ck[static_cast<long long>(tile) * K * V + i * V + lane + kWarp * c] =
            s[i][c];
    for (int e = lane; e < n * K; e += kWarp) {
      const int t = e / K, i = e % K;
      sk[t][i] = to_f(k[key_at(t0 + t, i)]);
      sd[t][i] = expf(w[key_at(t0 + t, i)]);
    }
    for (int t = 0; t < n; ++t)
#pragma unroll
      for (int c = 0; c < CV; ++c)
        sv[t][lane + kWarp * c] = to_f(v[val_at(t0 + t, lane + kWarp * c)]);
    __syncwarp();
    for (int t = 0; t < n; ++t)
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c)
          s[i][c] = fmaf(sd[t][i], s[i][c], sk[t][i] * sv[t][lane + kWarp * c]);
    __syncwarp();
  }

  // 2. reverse: the tiles from the last, each token's gradients
  float ds[K][CV];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c)
      ds[i][c] = ds_out[state0 + i * V + lane + kWarp * c];
  float du_acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) du_acc[i] = 0.f;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * NT, n = min(NT, T_len - t0);
    for (int e = lane; e < n * K; e += kWarp) {
      const int t = e / K, i = e % K;
      sr[t][i] = to_f(r[key_at(t0 + t, i)]);
      sk[t][i] = to_f(k[key_at(t0 + t, i)]);
      sd[t][i] = expf(w[key_at(t0 + t, i)]);
    }
    for (int t = 0; t < n; ++t)
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const int j = lane + kWarp * c;
        sv[t][j] = to_f(v[val_at(t0 + t, j)]);
        sdy[t][j] = to_f(dy[val_at(t0 + t, j)]);
      }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int c = 0; c < CV; ++c)
        s[i][c] =
            ck[static_cast<long long>(tile) * K * V + i * V + lane + kWarp * c];
    __syncwarp();
    // the tile's states, each lane its own columns
    for (int t = 0; t < n; ++t)
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const int j = lane + kWarp * c;
          ss[t][i][j] = s[i][c];
          s[i][c] = fmaf(sd[t][i], s[i][c], sk[t][i] * sv[t][j]);
        }
    for (int t = n - 1; t >= 0; --t) {
      float ruk = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) ruk = fmaf(sr[t][i] * uk[i], sk[t][i], ruk);
      float dyv = 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const int j = lane + kWarp * c;
        dyv = fmaf(sdy[t][j], sv[t][j], dyv);
      }
      dyv = warp_sum(dyv);
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const int j = lane + kWarp * c;
        float g = ruk * sdy[t][j];
#pragma unroll
        for (int i = 0; i < K; ++i) g = fmaf(ds[i][c], sk[t][i], g);
        dv[val_at(t0 + t, j)] = from_f<T>(g);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float a = 0.f, bb = 0.f, cc = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const int j = lane + kWarp * c;
          const float sp = ss[t][i][j];
          a = fmaf(sdy[t][j], sp, a);
          bb = fmaf(ds[i][c], sv[t][j], bb);
          cc = fmaf(sp, ds[i][c], cc);
          ds[i][c] = fmaf(sd[t][i], ds[i][c], sr[t][i] * sdy[t][j]);
        }
        a = warp_sum(a);
        bb = warp_sum(bb);
        cc = warp_sum(cc);
        if (lane == 0) {
          odr[t][i] = fmaf(uk[i] * sk[t][i], dyv, a);
          odk[t][i] = fmaf(sr[t][i] * uk[i], dyv, bb);
          odw[t][i] = sd[t][i] * cc;
        }
        du_acc[i] = fmaf(sr[t][i] * sk[t][i], dyv, du_acc[i]);
      }
    }
    __syncwarp();
    for (int e = lane; e < n * K; e += kWarp) {
      const int t = e / K, i = e % K;
      dr[key_at(t0 + t, i)] = from_f<T>(odr[t][i]);
      dk[key_at(t0 + t, i)] = from_f<T>(odk[t][i]);
      dw[key_at(t0 + t, i)] = odw[t][i];
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c)
      ds_in[state0 + i * V + lane + kWarp * c] = ds[i][c];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) du_part[static_cast<long long>(bh) * K + i] =
        du_acc[i];
  }
}

template <typename T, int K, int V>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, const void* dy,
           const float* ds_out, void* dr, void* dk, void* dv, float* dw,
           float* du_part, float* ds_in, float* ckpt, int B, int T_len,
           int H, cudaStream_t stream) {
  wkv6_keyslice_bwd_kernel<T, K, V><<<B * H, kWarp, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<const T*>(dy), ds_out,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
      du_part, ds_in, ckpt, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

// f(T{}, K, V as integral constants) for dtype 0 float32 / 1 bfloat16, V 32
// or 64 and K a power of two from 1 to 16 below V; anything else is refused
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
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (K >= V) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return keys(float{});
  if (dtype == 1) return keys(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Tokens a tile for K key rows of V columns (the scratch holds a state a
// tile: B * H * ceil(T / tile) * K * V floats), or -1 for a shape the
// kernel does not take.
extern "C" int aqua_wkv6_keyslice_bwd_tile(int K, int V) {
  return by_type(0, K, V, [&](auto, auto KC, auto VC) {
    return tile_tokens(decltype(KC)::value, decltype(VC)::value);
  });
}

// r, k, dr, dk: (B, T, H, K) and v, dy, dv: (B, T, H, V) of the compute
// dtype (0 float32, 1 bfloat16); w, dw: (B, T, H, K) float32; u: (H, K)
// float32; s0, ds_out, ds_in: (B, H, K, V) float32; du_part: (B, H, K)
// float32, each sequence's du, which the caller sums; ckpt: float32
// scratch of B * H * ceil(T / aqua_wkv6_keyslice_bwd_tile(K, V)) * K * V.
// V is 32 or 64 and K a power of two from 1 to 16 below it; T >= 1.
extern "C" int aqua_wkv6_keyslice_bwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds_in,
    void* ckpt, int B, int T_len, int H, int K, int V, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    return launch<decltype(t), decltype(KC)::value, decltype(VC)::value>(
        r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(s0), dy, static_cast<const float*>(ds_out),
        dr, dk, dv, static_cast<float*>(dw), static_cast<float*>(du_part),
        static_cast<float*>(ds_in), static_cast<float*>(ckpt), B, T_len, H,
        static_cast<cudaStream_t>(stream));
  });
}

// registers, local bytes (spills and stack), static shared memory and
// resident blocks per SM of the kernel at (dtype, K, V) into out[0..3]
extern "C" int aqua_wkv6_keyslice_bwd_info(int dtype, int K, int V,
                                           int* out) {
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    auto kernel = wkv6_keyslice_bwd_kernel<decltype(t), decltype(KC)::value,
                                           decltype(VC)::value>;
    cudaFuncAttributes a;
    if (int rc = static_cast<int>(cudaFuncGetAttributes(&a, kernel)))
      return rc;
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, kWarp,
                                                      0));
  });
}
