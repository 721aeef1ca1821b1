// Backward of the chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no Pallas backward and
// differentiates its jnp chunked form (src/repro/layers/rwkv6.py,
// wkv6_chunked) with jax.grad. This kernel is the backward of csrc/wkv6.cu's
// forward (which replaces wkv6 of src/repro/kernels/rwkv6_wkv/kernel.py)
// behind the port's autograd op; its plain twin, which fixes its
// math and order of operations, is wkv6_backward_plain in
// kernels/rwkv6_wkv/ref.py. Per (sequence b, head h), chunks of C = 32
// tokens (the last may be short), with S the chunk's entry state, lw the
// inclusive cumsum of w within the chunk, lw_prev[t] = lw[t - 1] (0 at the
// chunk's first token), a_t = e^{lw_prev_t}, D[t,tau] = e^{lw_prev_t -
// lw_tau} (tau < t), b_tau = e^{lw_last - lw_tau}, vdy[t,tau] = v_tau . dy_t
// and dS the gradient of the chunk's exit state:
//
//   dv_tau = sum_{t>=tau} A[t,tau] dy_t + (k_tau b_tau)^T dS
//   dr_t   = a_t (S dy_t) + sum_{tau<t} D k_tau vdy[t,tau] + u k_t vdy[t,t]
//   dk_tau = sum_{t>tau} D r_t vdy[t,tau] + u r_tau vdy[tau,tau]
//            + b_tau (dS v_tau)
//   du    += sum_t r_t k_t vdy[t,t]
//   dw_s   = sum_{t>s} X_t - sum_{t>=s} YA_t + sum_{t<s} YS_t + Z
//   dS    <- sum_t (r_t a_t) dy_t^T + e^{lw_last} dS
//
// (X_t = r_t (dr_t without its u term), YA = k (dk's pairwise sum), YS =
// k b (dS v), Z = e^{lw_last} rowsum(S * dS)). Every exponent is <= 0: lw
// is a serial float sum of non-positive terms, so it is non-increasing in t
// exactly, and each difference above subtracts a later cumsum from an
// earlier one.
//
// Bound: at the training shape (B 4, T 2048, H 40, hd 64, bf16 r/k/v/dy and
// dr/dk/dv, f32 w/dw and states) the call must move ~461 MB (~0.14 ms at
// 3.35 TB/s), do ~1.9e10 f32 operations (~0.28 ms at 67 TFLOP/s) and
// ~1.1e9 exponentials (~0.26 ms on the special-function units): it is
// bound by its operations.
//
// Design, simple and right (no tensor cores, no TMA): one block of 256
// threads per (b, h), walking its chunks in a loop.
//   1. A forward sweep recomputes each chunk's entry state and writes it to
//      a float32 scratch (B, H, nt, hd, hd) that the wrapper allocates.
//   2. The chunks in reverse, dS in shared memory: per chunk, the rows of
//      r, k, v, dy as float and lw, b, e^{lw_last} (one thread a key dim,
//      serial over the chunk); then vdy and A (a thread a pair, the D term
//      rebuilt from lw, never stored), S dy and dS v (a thread a row and
//      key dim); then dr and dk (a thread a key dim and every fourth token,
//      so per pair one subtract, one ex2 and one fused multiply-add) and dv;
//      then dw by one serial scan a key dim; then dS in place.
//   Rows are padded to hd + 1 floats so a warp's 32 lanes, reading 32 rows
//   or 32 columns, land on distinct banks. du is summed per block in a
//   fixed order and written per (b, h); the wrapper sums over B, so no
//   result depends on the order blocks finish in (two launches agree bit
//   for bit). ~107 KB of shared memory at hd 64: two blocks an SM, the 160
//   blocks of the training shape in one wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using tc::bf16;

constexpr int kChunk = 32;
constexpr int kThreads = 256;
constexpr int LC = kChunk + 1;                // padded (C, C) row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <int HD>
struct BwdCfg {
  static_assert(HD == 32 || HD == 64, "head dims 32 and 64");
  static constexpr int LD = HD + 1;             // padded float row
  static constexpr int NG = kThreads / HD;      // token groups a key dim
  static constexpr int kRows = kChunk * LD;     // one (C, hd) tile
  static constexpr int kState = HD * LD;        // one (hd, hd) tile
  // float offsets into shared memory
  static constexpr int oR = 0;                  // r, then r * a
  static constexpr int oK = oR + kRows;
  static constexpr int oV = oK + kRows;
  static constexpr int oDY = oV + kRows;
  static constexpr int oLW = oDY + kRows;       // lw in log2 units
  static constexpr int oB = oLW + kRows;        // b = 2^{lw_last - lw}
  static constexpr int oS = oB + kRows;         // entry state, then YA
  static constexpr int oDS = oS + kState;       // dS
  static constexpr int oVDY = oDS + kState;     // vdy [t][tau]
  static constexpr int oA = oVDY + kChunk * LC; // A [t][tau]
  static constexpr int oSDY = oA + kChunk * LC; // S dy, then X - YA
  static constexpr int oDSV = oSDY + kRows;     // dS v, then YS
  static constexpr int oZ = oDSV + kRows;
  static constexpr int oDec = oZ + HD;          // 2^{lw_last}
  static constexpr int oU = oDec + HD;
  static constexpr int oDU = oU + HD;           // [NG][HD]
  static constexpr size_t kSmem = sizeof(float) * (oDU + NG * HD);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ dy, const float* __restrict__ ds_out,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds_in, float* __restrict__ scratch,
                int T_len, int H) {
  using C = BwdCfg<HD>;
  constexpr int LD = C::LD, NG = C::NG;
  extern __shared__ __align__(16) float smem[];
  float* R = smem + C::oR;
  float* K = smem + C::oK;
  float* V = smem + C::oV;
  float* DY = smem + C::oDY;
  float* LW = smem + C::oLW;
  float* BX = smem + C::oB;
  float* S = smem + C::oS;
  float* YA = smem + C::oS;
  float* DS = smem + C::oDS;
  float* VDY = smem + C::oVDY;
  float* AM = smem + C::oA;
  float* SDY = smem + C::oSDY;
  float* DSV = smem + C::oDSV;
  float* Z = smem + C::oZ;
  float* DEC = smem + C::oDec;
  float* US = smem + C::oU;
  float* DU = smem + C::oDU;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, h = bh % H;
  const int tok = H * HD;              // elements between two tokens
  const long long base =
      (static_cast<long long>(bh / H) * T_len * H + h) * HD;
  const int nt = (T_len + kChunk - 1) / kChunk;
  float* scr = scratch + static_cast<long long>(bh) * nt * HD * HD;

  auto load_rows = [&](float* dst, const T* src, int t0, int cn) {
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      dst[t * LD + i] = to_f(src[base + (t0 + t) * tok + i]);
    }
  };
  // lw (log2 units), b and 2^{lw_last} of the chunk's key dims
  auto decays = [&](int t0, int cn) {
    if (tid < HD) {
      const int i = tid;
      float acc = 0.f;
      for (int t = 0; t < cn; ++t) {
        acc += w[base + (t0 + t) * tok + i] * kLog2e;
        LW[t * LD + i] = acc;
      }
      DEC[i] = ex2(acc);
      for (int t = 0; t < cn; ++t) BX[t * LD + i] = ex2(acc - LW[t * LD + i]);
    }
  };

  for (int e = tid; e < HD; e += kThreads) US[e] = u[h * HD + e];
  for (int e = tid; e < HD * HD; e += kThreads)
    S[(e / HD) * LD + e % HD] = s0[static_cast<long long>(bh) * HD * HD + e];

  // -- 1. forward sweep: each chunk's entry state into the scratch --------
  for (int c = 0; c < nt; ++c) {
    const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
    __syncthreads();                   // S of chunk c complete
    for (int e = tid; e < HD * HD; e += kThreads)
      scr[static_cast<long long>(c) * HD * HD + e] = S[(e / HD) * LD + e % HD];
    if (c + 1 == nt) break;            // the exit state is not needed
    load_rows(K, k, t0, cn);
    load_rows(V, v, t0, cn);
    decays(t0, cn);
    __syncthreads();
    for (int e = tid; e < HD * HD; e += kThreads) {
      const int i = e / HD, j = e % HD;
      float acc = DEC[i] * S[i * LD + j];
      for (int t = 0; t < cn; ++t)
        acc = fmaf(K[t * LD + i] * BX[t * LD + i], V[t * LD + j], acc);
      S[i * LD + j] = acc;
    }
  }

  // -- 2. the chunks in reverse, carrying dS ------------------------------
  for (int e = tid; e < HD * HD; e += kThreads)
    DS[(e / HD) * LD + e % HD] =
        ds_out[static_cast<long long>(bh) * HD * HD + e];
  const int my_i = tid % HD, my_g = tid / HD;
  float du_acc = 0.f;
  for (int c = nt - 1; c >= 0; --c) {
    const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
    __syncthreads();                   // chunk c + 1 done (S read, dS set)
    load_rows(R, r, t0, cn);
    load_rows(K, k, t0, cn);
    load_rows(V, v, t0, cn);
    load_rows(DY, dy, t0, cn);
    for (int e = tid; e < HD * HD; e += kThreads)
      S[(e / HD) * LD + e % HD] = scr[static_cast<long long>(c) * HD * HD + e];
    decays(t0, cn);
    __syncthreads();

    // vdy[t][tau] and A[t][tau] for tau <= t: a thread a pair, lanes over
    // tau (distinct rows: distinct banks), row t's operands broadcast
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int t = e / kChunk, s = e % kChunk;
      if (t >= cn || s > t) continue;
      float d = 0.f, a = 0.f;
      for (int j = 0; j < HD; ++j)
        d = fmaf(V[s * LD + j], DY[t * LD + j], d);
      if (s < t) {
        const float* lp = LW + (t - 1) * LD;     // lw_prev of row t
        for (int i = 0; i < HD; ++i)
          a = fmaf(R[t * LD + i] * K[s * LD + i],
                   ex2(lp[i] - LW[s * LD + i]), a);
      } else {
        for (int i = 0; i < HD; ++i)
          a = fmaf(R[t * LD + i] * US[i], K[t * LD + i], a);
      }
      VDY[t * LC + s] = d;
      AM[t * LC + s] = a;
    }
    // S dy_t and dS v_t: a thread a (t, i), lanes over i
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      float a = 0.f, b = 0.f;
      for (int j = 0; j < HD; ++j) {
        a = fmaf(S[i * LD + j], DY[t * LD + j], a);
        b = fmaf(DS[i * LD + j], V[t * LD + j], b);
      }
      SDY[t * LD + i] = a;
      DSV[t * LD + i] = b;
    }
    if (tid < HD) {
      float z = 0.f;
      for (int j = 0; j < HD; ++j)
        z = fmaf(S[tid * LD + j], DS[tid * LD + j], z);
      Z[tid] = DEC[tid] * z;
    }
    __syncthreads();

    // dr, dk (key dim my_i, tokens my_g, my_g + NG, ...) and dv (value dim
    // my_i, the same tokens)
    {
      const int i = my_i;
      const float ui = US[i];
      for (int t = my_g; t < cn; t += NG) {
        const float lwp = t ? LW[(t - 1) * LD + i] : 0.f;
        const float ri = R[t * LD + i], ki = K[t * LD + i];
        const float vd = VDY[t * LC + t];
        float pr = 0.f;                // sum_{tau<t} D k_tau vdy[t][tau]
        for (int s = 0; s < t; ++s)
          pr = fmaf(ex2(lwp - LW[s * LD + i]) * K[s * LD + i],
                    VDY[t * LC + s], pr);
        float pk = 0.f;                // sum_{t2>t} D r_t2 vdy[t2][t]
        for (int t2 = t + 1; t2 < cn; ++t2)
          pk = fmaf(ex2(LW[(t2 - 1) * LD + i] - LW[t * LD + i]) *
                        R[t2 * LD + i],
                    VDY[t2 * LC + t], pk);
        const float x = ex2(lwp) * SDY[t * LD + i] + pr;
        const float bds = BX[t * LD + i] * DSV[t * LD + i];
        const int o = (t0 + t) * tok + i;
        dr[base + o] = from_f<T>(x + ui * ki * vd);
        dk[base + o] = from_f<T>(pk + ui * ri * vd + bds);
        du_acc = fmaf(ri * ki, vd, du_acc);
        const float ya = ki * pk;
        SDY[t * LD + i] = ri * x - ya;     // X - YA
        DSV[t * LD + i] = ki * bds;        // YS
        YA[t * LD + i] = ya;
      }
      const int j = my_i;
      for (int s = my_g; s < cn; s += NG) {
        float acc = 0.f;
        for (int t = s; t < cn; ++t)
          acc = fmaf(AM[t * LC + s], DY[t * LD + j], acc);
        for (int q = 0; q < HD; ++q)
          acc = fmaf(K[s * LD + q] * BX[s * LD + q], DS[q * LD + j], acc);
        dv[base + (t0 + s) * tok + j] = from_f<T>(acc);
      }
    }
    __syncthreads();

    // r * a in place (for dS), and dw: one serial scan a key dim
    for (int e = tid; e < cn * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      R[t * LD + i] *= ex2(t ? LW[(t - 1) * LD + i] : 0.f);
    }
    if (tid < HD) {
      const int i = tid;
      float run = 0.f;                 // sum_{t<s} YS_t, in place
      for (int s = 0; s < cn; ++s) {
        const float ys = DSV[s * LD + i];
        DSV[s * LD + i] = run;
        run += ys;
      }
      float after = 0.f;               // sum_{t>s} (X_t - YA_t)
      for (int s = cn - 1; s >= 0; --s) {
        dw[base + (t0 + s) * tok + i] =
            after - YA[s * LD + i] + DSV[s * LD + i] + Z[i];
        after += SDY[s * LD + i];
      }
    }
    __syncthreads();

    // dS = sum_t (r_t a_t) dy_t^T + 2^{lw_last} dS, in place
    for (int e = tid; e < HD * HD; e += kThreads) {
      const int i = e / HD, j = e % HD;
      float acc = DEC[i] * DS[i * LD + j];
      for (int t = 0; t < cn; ++t)
        acc = fmaf(R[t * LD + i], DY[t * LD + j], acc);
      DS[i * LD + j] = acc;
    }
  }
  DU[my_g * HD + my_i] = du_acc;
  __syncthreads();
  for (int e = tid; e < HD * HD; e += kThreads)
    ds_in[static_cast<long long>(bh) * HD * HD + e] =
        DS[(e / HD) * LD + e % HD];
  if (tid < HD) {
    float s = 0.f;
    for (int g = 0; g < NG; ++g) s += DU[g * HD + tid];
    du_part[static_cast<long long>(bh) * HD + tid] = s;
  }
}

template <typename T, int HD>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BwdCfg<HD>::kSmem)));
}

// registers, local bytes, dynamic shared memory and resident blocks per SM
template <typename T, int HD>
int info_of(int* out) {
  if (int rc = prepare<T, HD>()) return rc;
  if (int rc = tc::info(wkv6_bwd_kernel<T, HD>, BwdCfg<HD>::kSmem, out))
    return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], wkv6_bwd_kernel<T, HD>, kThreads, BwdCfg<HD>::kSmem));
}

// f(T{}, std::integral_constant<int, hd>) for dtype 0 float32 / 1 bfloat16
// and hd 32 / 64; anything else is refused
template <typename F>
int by_type(int dtype, int hd, F&& f) {
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  if (dtype == 0 && hd == 64) return f(float{}, I64());
  if (dtype == 0 && hd == 32) return f(float{}, I32());
  if (dtype == 1 && hd == 64) return f(bf16{}, I64());
  if (dtype == 1 && hd == 32) return f(bf16{}, I32());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v, dy, dr, dk, dv: (B, T, H, hd) of the compute dtype (0 float32,
// 1 bfloat16); w, dw: (B, T, H, hd) float32; u: (H, hd) float32; s0,
// ds_out, ds_in: (B, H, hd, hd) float32; du_part: (B, H, hd) float32, the
// per-sequence du the caller sums over B; scratch: (B, H, ceil(T / 32),
// hd, hd) float32. hd is 32 or 64; T >= 1.
extern "C" int aqua_wkv6_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* ds_out, void* dr,
                             void* dk, void* dv, void* dw, void* du_part,
                             void* ds_in, void* scratch, int B, int T_len,
                             int H, int hd, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, hd, [&](auto t, auto HDc) {
    using T = decltype(t);
    constexpr int HD = decltype(HDc)::value;
    if (int rc = prepare<T, HD>()) return rc;
    wkv6_bwd_kernel<T, HD><<<B * H, kThreads, BwdCfg<HD>::kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<const T*>(dy), static_cast<const float*>(ds_out),
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(dw), static_cast<float*>(du_part),
        static_cast<float*>(ds_in), static_cast<float*>(scratch), T_len, H);
    return static_cast<int>(cudaGetLastError());
  });
}

// out[0..3]: registers, local bytes (spills and stack), dynamic shared
// memory and resident blocks per SM of the backward kernel for dtype and hd
extern "C" int aqua_wkv6_bwd_info(int dtype, int hd, int* out) {
  return by_type(dtype, hd, [&](auto t, auto HDc) {
    return info_of<decltype(t), decltype(HDc)::value>(out);
  });
}
