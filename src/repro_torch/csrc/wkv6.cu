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
// strong decays, and lw is made non-increasing in t by construction (below),
// so no rounding turns a difference positive. Unlike the TPU kernel, T need
// not be a multiple of C: the last chunk may be short (the engine launches
// T = 1 for decode lanes and the chunk buckets 8..256).
//
// Bound: at the engine's chunk shape (B 8, T 256, H 40, hd 64, bf16 r/k/v/y,
// f32 w and state) the call must move ~73 MB (r, k, v, y 2 bytes each, w 4,
// the state read and written once in f32), ~22 us at 3.35 TB/s. The chunked
// algorithm does ~1.9e9 f32 operations (~28 us at 67 TFLOP/s) and ~9.2e7
// exponentials on the causal pairs (~22 us on the 16 special-function units
// of each SM at the 1.98 GHz boost clock). The three are within 30% of each
// other; at T = 1 (decode) the state's bytes set the bound.
//
// Design: one block of 256 threads per (b, h) walks the chunks in order
// (the TPU's sequential grid axis becomes the loop), with S in shared
// memory; 320 blocks at the engine's shape, three resident on each SM (at
// most 80 registers a thread, ~74 KB of shared memory a block), so the grid
// runs in one wave. Each chunk has three barriers, one per dependence:
//
//   staging: chunk c + 1's raw r, k, v rows (bf16 or f32 bytes) are copied
//     by cp.async into the second buffer of a two-stage ring while chunk c
//     computes (float32 inputs take one stage: two would not leave room for
//     three blocks) and converted to float where a row is read; chunk c +
//     1's w rows land by cp.async in lw's buffer once A has read it.
//   cumsum: a lane holds 4 consecutive tokens of hd / 32 key dims: a
//     serial sum over its tokens, then the groups' totals by __shfl_up_sync
//     (lanes 4 apart), in log2 units (w scaled by log2 e once, so each
//     exponential is one ex2.approx); a running minimum over the groups
//     then makes lw non-increasing in t exactly, so no rounding turns a
//     difference below positive. The same lanes write r * 2^{lw_prev}
//     transposed (i-major, for the y product), k * 2^{lw_last - lw}, the
//     decay, and the partial sums of A's diagonal and of its pairs
//     (t, t - 1).
//   A: the 465 causal pairs tau < t - 1 in 2 x 2 blocks of two rows and
//     two taus, 15 a warp (rows f, f + 1 and 30 - f, 31 - f for f = 2 x
//     warp), each block on a pair of lanes 16 apart over half of the key
//     dims, so every row read serves two pairs; per pair and key dim one
//     subtract, one ex2 and one fused multiply-add. The pairs (t, t - 1),
//     whose exponent is 0, and the diagonal's u term are dot products the
//     cumsum already summed. Then y_cross = rq @ S on 4 x hd / 16 register
//     tiles, each summed by a pair of lanes over half of i.
//   y and the state: the lane pairs add A @ v over half of tau each, then
//     their two halves by one shuffle; S = 2^{lw_last} * S + k_tail^T v is
//     updated in place on hd / 16 x hd / 16 register tiles (every read of
//     the old S is behind the barrier). In every product a quarter-warp
//     shares its row operand, so that load is a broadcast, and each 8- or
//     16-byte load feeds 8 or 16 fused multiply-adds.
//
// Shared-memory loads and shuffles (the MIO pipe), not the arithmetic, set
// the pace on the H100: per chunk the A build, the y product and the state
// update each take about a quarter of them. Padded rows (raw rows + 16
// bytes, float rows hd + 4) keep the lanes of a 16-byte load on distinct
// banks. All arithmetic is float32 with explicit fmaf (the build passes
// -fmad=false); ex2.approx.ftz has a relative error of ~2^-22, far inside
// the 1e-3 tolerance the kernel is held to.
//
// Tensor cores were not taken: they remove only the operations' limit
// (~28 us), not the bytes' or the exponentials' (~22 us each), and a TF32
// or bf16 rounding of k * 2^{lw_last - lw} costs ~5e-4 relative a term
// against the state's rtol 1e-3. They are worth it only if this kernel
// turns out bound by its fused multiply-adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using tc::bf16;

constexpr int kChunk = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;                 // resident blocks per SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive values at p (N * sizeof(T) bytes, aligned to that size or
// to 16 bytes) as float
template <int N>
__device__ __forceinline__ void load_f(float (&o)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = x.x;
      o[4 * q + 1] = x.y;
      o[4 * q + 2] = x.z;
      o[4 * q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    static_assert(N == 1, "one, two or a multiple of four floats");
    o[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_f(float (&o)[N], const bf16* p) {
  if constexpr (N == 1) {
    o[0] = __bfloat162float(*p);
  } else {
    uint32_t u[N / 2];
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        const uint4 x = reinterpret_cast<const uint4*>(p)[q];
        u[4 * q] = x.x;
        u[4 * q + 1] = x.y;
        u[4 * q + 2] = x.z;
        u[4 * q + 3] = x.w;
      }
    } else if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      u[0] = x.x;
      u[1] = x.y;
    } else {
      static_assert(N == 2, "one, two, four or a multiple of eight bf16");
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      o[2 * e] = __uint_as_float(u[e] << 16);
      o[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* p, const float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    static_assert(N == 1, "one, two or a multiple of four floats");
    *p = o[0];
  }
}
template <int N>
__device__ __forceinline__ void store_f(bf16* p, const float (&o)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(tc::pack_bf16(o[0], o[1]), tc::pack_bf16(o[2], o[3]));
  } else {
    static_assert(N == 2, "two or four bf16");
    *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(o[0], o[1]);
  }
}

template <typename T, int HD>
struct Cfg {
  static_assert(HD == 32 || HD == 64, "head dims 32 and 64");
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kRowBytes = HD * sizeof(T) + 16;   // padded raw row
  static constexpr int kPieces = HD * sizeof(T) / 16;     // 16 B per row
  static constexpr int kStageBytes = 3 * kChunk * kRowBytes;  // r, k, v
  static constexpr int kEpc = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int LD = HD + 4;             // padded float row
  static constexpr int ND = HD / kWarps / 4;    // cumsum: key dims a lane
  static constexpr int SB = HD / 16;            // state tile: SB x SB
  static constexpr int YJ = HD / 16;            // y tile: 4 x YJ
  // float offsets into shared memory, each a multiple of 4
  static constexpr int oS = 0;                         // S [HD][HD]
  static constexpr int oRq = oS + HD * HD;             // rq^T [HD][C]
  static constexpr int oKt = oRq + HD * kChunk;        // k_tail [C][LD]
  static constexpr int oLw = oKt + kChunk * LD;        // w, then lw [C][LD]
  static constexpr int oA = oLw + kChunk * LD;         // A^T [C][C]
  static constexpr int oDecay = oA + kChunk * kChunk;  // 2^{lw_last} [HD]
  static constexpr int oU = oDecay + HD;               // u [HD]
  static constexpr int oDiag = oU + HD;                // [warps][C]
  static constexpr int oSub = oDiag + kWarps * kChunk;  // [warps][C / 2]
  static constexpr int oStage = oSub + kWarps * kChunk / 2;
  static constexpr size_t kSmem =
      sizeof(float) * oStage + kStages * kStageBytes;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int T_len, int H) {
  using C = Cfg<T, HD>;
  constexpr int RB = C::kRowBytes, LD = C::LD, ND = C::ND, SB = C::SB;
  extern __shared__ __align__(16) float smem[];
  float* S = smem + C::oS;
  float* rqT = smem + C::oRq;
  float* kt = smem + C::oKt;
  float* lw = smem + C::oLw;
  float* AT = smem + C::oA;
  float* decay = smem + C::oDecay;
  float* us = smem + C::oU;
  float* diagp = smem + C::oDiag;
  float* subp = smem + C::oSub;
  char* stage = reinterpret_cast<char*>(smem + C::oStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, h = bh % H;
  const int tok = H * HD;              // elements between two tokens
  const long long base =
      (static_cast<long long>(bh / H) * T_len * H + h) * HD;

  // chunk rows [t0, t0 + cn) of r, k, v into stage buffer buf
  auto load_stage = [&](int t0, int cn, int buf) {
    char* dst = stage + buf * C::kStageBytes;
    const T* src[3] = {r + base, k + base, v + base};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int e = tid; e < cn * C::kPieces; e += kThreads) {
        const int t = e / C::kPieces, p = e % C::kPieces;
        tc::cp_async16(tc::saddr(dst + (a * kChunk + t) * RB + p * 16),
                       src[a] + (t0 + t) * tok + p * C::kEpc, 16);
      }
    tc::cp_commit();
  };
  // chunk rows [t0, t0 + cn) of w into lw's rows (the cumsum runs in place)
  auto load_w = [&](int t0, int cn) {
    for (int e = tid; e < cn * (HD / 4); e += kThreads) {
      const int t = e / (HD / 4), p = e % (HD / 4);
      tc::cp_async16(tc::saddr(lw + t * LD + 4 * p),
                     w + base + (t0 + t) * tok + 4 * p, 16);
    }
    tc::cp_commit();
  };

  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  load_stage(0, min(kChunk, T_len), 0);
  load_w(0, min(kChunk, T_len));
  {
    const float* s = s0 + static_cast<long long>(bh) * HD * HD;
    for (int e = tid; e < HD * HD / 4; e += kThreads)
      reinterpret_cast<float4*>(S)[e] = reinterpret_cast<const float4*>(s)[e];
  }
  for (int e = tid; e < HD; e += kThreads) us[e] = u[h * HD + e];
  for (int e = tid; e < kChunk * kChunk; e += kThreads) AT[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
    const int buf = c % C::kStages;
    if (C::kStages == 1 && c > 0) {
      __syncthreads();                 // chunk c - 1's rows are read
      load_stage(t0, cn, 0);
    }
    tc::cp_wait<0>();
    __syncthreads();                   // chunk c staged; c - 1 done
    if (C::kStages == 2 && c + 1 < n_chunks)
      load_stage(t0 + kChunk, min(kChunk, T_len - t0 - kChunk), buf ^ 1);
    const char* rs = stage + buf * C::kStageBytes;
    const char* ks = rs + kChunk * RB;
    const char* vs = ks + kChunk * RB;

    // -- cumsum: a lane holds tokens 4g .. 4g + 3 of ND key dims ----------
    {
      const int g = lane >> 2, p = lane & 3, ip = warp * (4 * ND) + p * ND;
      float x[4][ND], rr[4][ND], kk[4][ND];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * g + tt;
        load_f(x[tt], lw + t * LD + ip);
        load_f(rr[tt], reinterpret_cast<const T*>(rs + t * RB) + ip);
        load_f(kk[tt], reinterpret_cast<const T*>(ks + t * RB) + ip);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          x[tt][d] = t < cn ? x[tt][d] * kLog2e : 0.f;
      }
      float prev0[ND], last[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        // serial within the lane (each sum <= the one before), then the
        // groups' totals by __shfl_up_sync over lanes 4 apart
#pragma unroll
        for (int tt = 1; tt < 4; ++tt) x[tt][d] += x[tt - 1][d];
        float tot = x[3][d];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(kFull, tot, off);
          if (lane >= off) tot += o;
        }
        const float excl = __shfl_up_sync(kFull, tot, 4);
        if (g > 0) {
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) x[tt][d] += excl;
        }
        // clamp each group to the least last value before it: lw is then
        // non-increasing in t exactly, so no exponent below is positive
        float m = x[3][d];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(kFull, m, off);
          if (lane >= off) m = fminf(m, o);
        }
        const float pm = __shfl_up_sync(kFull, m, 4);
        if (g > 0) {
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) x[tt][d] = fminf(x[tt][d], pm);
        }
        const float p0 = __shfl_up_sync(kFull, x[3][d], 4);
        prev0[d] = g > 0 ? p0 : 0.f;
        const int tl = (cn - 1) & 3;
        const float xl = tl == 0 ? x[0][d] : tl == 1 ? x[1][d]
                       : tl == 2 ? x[2][d] : x[3][d];
        last[d] = __shfl_sync(kFull, xl, ((cn - 1) >> 2) * 4 + p);
      }
      // A[t][t - 1] takes no exponential (lw_prev[t] = lw[t - 1]): its
      // partial sums for the odd t of this lane, while k is still k
      float sd1 = 0.f, sd3 = 0.f;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        sd1 = fmaf(rr[1][d], kk[0][d], sd1);
        sd3 = fmaf(rr[3][d], kk[2][d], sd3);
      }
      float dg[4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * g + tt;
        store_f(lw + t * LD + ip, x[tt]);
        dg[tt] = 0.f;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          dg[tt] = fmaf(rr[tt][d] * us[ip + d], kk[tt][d], dg[tt]);
          kk[tt][d] *= ex2(last[d] - x[tt][d]);
        }
        store_f(kt + t * LD + ip, kk[tt]);
      }
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const float q4[4] = {rr[0][d] * ex2(prev0[d]), rr[1][d] * ex2(x[0][d]),
                             rr[2][d] * ex2(x[1][d]), rr[3][d] * ex2(x[2][d])};
        store_f(rqT + (ip + d) * kChunk + 4 * g, q4);
        if (g == 0) decay[ip + d] = ex2(last[d]);
      }
      // the diagonal's partial sums over this warp's key dims: lane 4g + p
      // ends with token 4g + p's
      const bool hi = p & 2;
      float a0 = hi ? dg[2] : dg[0], a1 = hi ? dg[3] : dg[1];
      a0 += __shfl_xor_sync(kFull, hi ? dg[0] : dg[2], 2);
      a1 += __shfl_xor_sync(kFull, hi ? dg[1] : dg[3], 2);
      const bool odd = p & 1;
      const float keep = (odd ? a1 : a0) +
                         __shfl_xor_sync(kFull, odd ? a0 : a1, 1);
      diagp[warp * kChunk + lane] = keep;
      float sd = (hi ? sd3 : sd1) + __shfl_xor_sync(kFull, hi ? sd1 : sd3, 2);
      sd += __shfl_xor_sync(kFull, sd, 1);
      if (!odd) subp[warp * (kChunk / 2) + 2 * g + (p >> 1)] = sd;
    }
    __syncthreads();

    // -- A over the causal pairs tau < t - 1 (the diagonal's u term and
    // the pairs (t, t - 1) were summed by the cumsum) ---------------------
    {
      // 2 x 2 blocks: a warp takes rows f0, f0 + 1 (tau < f0) and rows
      // 30 - f0, 31 - f0 (tau < 30 - f0), f0 = 2 x warp: 15 blocks of two
      // rows and two taus, each on a pair of lanes 16 apart over half of the
      // key dims, so each row operand read serves two pairs
      const int f0 = 2 * warp, nl = warp, nh = 15 - warp;
      const int half = lane >> 4, blk = lane & 15;
      const bool low = blk < nl;
      const int ta = low ? f0 : 30 - f0, tb = ta + 1;
      const int tau_a = low ? blk : blk - nl, tau_b = tau_a + (low ? nl : nh);
      const bool live = blk < 15 && ta < cn;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      if (live) {
        const T* k0 = reinterpret_cast<const T*>(ks + tau_a * RB);
        const T* k1 = reinterpret_cast<const T*>(ks + tau_b * RB);
        const T* r0 = reinterpret_cast<const T*>(rs + ta * RB);
        const T* r1 = reinterpret_cast<const T*>(rs + tb * RB);
        const float* l0 = lw + tau_a * LD;
        const float* l1 = lw + tau_b * LD;
        const float* p0 = lw + (ta - 1) * LD;   // lw_prev of row ta
        const float* p1 = lw + ta * LD;         // lw_prev of row tb
#pragma unroll 2
        for (int i = half * (HD / 2); i < (half + 1) * (HD / 2); i += 4) {
          float kx0[4], kx1[4], x0[4], x1[4], e0[4], e1[4], q0[4], q1[4];
          load_f(kx0, k0 + i);
          load_f(kx1, k1 + i);
          load_f(x0, r0 + i);
          load_f(x1, r1 + i);
          load_f(e0, l0 + i);
          load_f(e1, l1 + i);
          load_f(q0, p0 + i);
          load_f(q1, p1 + i);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a00 = fmaf(x0[q] * kx0[q], ex2(q0[q] - e0[q]), a00);
            a01 = fmaf(x0[q] * kx1[q], ex2(q0[q] - e1[q]), a01);
            a10 = fmaf(x1[q] * kx0[q], ex2(q1[q] - e0[q]), a10);
            a11 = fmaf(x1[q] * kx1[q], ex2(q1[q] - e1[q]), a11);
          }
        }
      }
      a00 += __shfl_xor_sync(kFull, a00, 16);
      a01 += __shfl_xor_sync(kFull, a01, 16);
      a10 += __shfl_xor_sync(kFull, a10, 16);
      a11 += __shfl_xor_sync(kFull, a11, 16);
      if (live) {
        if (half == 0) {
          AT[tau_a * kChunk + ta] = a00;
          AT[tau_b * kChunk + ta] = a01;
        } else if (tb < cn) {
          AT[tau_a * kChunk + tb] = a10;
          AT[tau_b * kChunk + tb] = a11;
        }
      }
      if (lane < 4) {
        const int t = 4 * warp + lane;
        float s = 0.f, sd = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          s += diagp[q * kChunk + t];
          sd += subp[q * (kChunk / 2) + (t >> 1)];
        }
        AT[t * kChunk + t] = s;
        if (t & 1) AT[(t - 1) * kChunk + t] = sd;
      }
    }

    // -- y = rq @ S + A @ v on 4 x YJ tiles (rows t4 .. t4 + 4, columns
    // jy .. jy + YJ), each summed by a pair of lanes 16 apart over half of
    // i (and of tau), then added across the pair. A quarter-warp shares its
    // rows, so the row operand's loads are broadcast ----------------------
    constexpr int YJ = C::YJ;
    const int half = lane >> 4;
    const int t4 = ((warp >> 1) * 2 + ((lane >> 3) & 1)) * 4;
    const int jy = ((warp & 1) * 8 + (lane & 7)) * YJ;
    float acc[4][YJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < YJ; ++q) acc[a][q] = 0.f;
    if (t4 < cn) {
#pragma unroll 4
      for (int i = half * (HD / 2); i < (half + 1) * (HD / 2); ++i) {
        float rq[4], sv[YJ];
        load_f(rq, rqT + i * kChunk + t4);
        load_f(sv, S + i * HD + jy);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < YJ; ++q)
            acc[a][q] = fmaf(rq[a], sv[q], acc[a][q]);
      }
    }
    __syncthreads();
    if (c + 1 < n_chunks)
      load_w(t0 + kChunk, min(kChunk, T_len - t0 - kChunk));

    // (A's diagonal holds the u term)
    if (t4 < cn) {
      const int tau_end = min(8 * ((warp >> 1) + 1), cn);
#pragma unroll 2
      for (int s = half; s < tau_end; s += 2) {
        float at[4], vv[YJ];
        load_f(at, AT + s * kChunk + t4);
        load_f(vv, reinterpret_cast<const T*>(vs + s * RB) + jy);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < YJ; ++q)
            acc[a][q] = fmaf(at[a], vv[q], acc[a][q]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {      // this lane keeps rows t4 + 2 half + a
      float o[YJ];
#pragma unroll
      for (int q = 0; q < YJ; ++q) {
        const float mine = half ? acc[2 + a][q] : acc[a][q];
        const float theirs = half ? acc[a][q] : acc[2 + a][q];
        o[q] = mine + __shfl_xor_sync(kFull, theirs, 16);
      }
      const int t = t4 + 2 * half + a;
      if (t < cn) store_f(y + base + (t0 + t) * tok + jy, o);
    }
    // -- S = 2^{lw_last} * S + k_tail^T v, in place: rows i0 .. i0 + SB,
    // columns j0 .. j0 + SB (every read of S for y_cross is done) ------------
    {
      const int i0 = ((warp >> 1) * 4 + (lane >> 3)) * SB;
      const int j0 = ((warp & 1) * 8 + (lane & 7)) * SB;
      float st[SB][SB], dec[SB];
      load_f(dec, decay + i0);
#pragma unroll
      for (int a = 0; a < SB; ++a) {
        load_f(st[a], S + (i0 + a) * HD + j0);
#pragma unroll
        for (int q = 0; q < SB; ++q) st[a][q] *= dec[a];
      }
#pragma unroll 2
      for (int t = 0; t < cn; ++t) {
        float kv[SB], vv[SB];
        load_f(kv, kt + t * LD + i0);
        load_f(vv, reinterpret_cast<const T*>(vs + t * RB) + j0);
#pragma unroll
        for (int a = 0; a < SB; ++a)
#pragma unroll
          for (int q = 0; q < SB; ++q) st[a][q] = fmaf(kv[a], vv[q], st[a][q]);
      }
#pragma unroll
      for (int a = 0; a < SB; ++a) store_f(S + (i0 + a) * HD + j0, st[a]);
    }
  }
  __syncthreads();
  {
    float* s = s_out + static_cast<long long>(bh) * HD * HD;
    for (int e = tid; e < HD * HD / 4; e += kThreads)
      reinterpret_cast<float4*>(s)[e] = reinterpret_cast<const float4*>(S)[e];
  }
}

template <typename T, int HD>
int prepare() {
  const auto kernel = wkv6_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<T, HD>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out, int B,
           int T_len, int H, cudaStream_t stream) {
  if (int rc = prepare<T, HD>()) return rc;
  wkv6_kernel<T, HD><<<B * H, kThreads, Cfg<T, HD>::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, T_len,
      H);
  return static_cast<int>(cudaGetLastError());
}

// registers, local bytes, dynamic shared memory and resident blocks per SM
template <typename T, int HD>
int info_of(int* out) {
  if (int rc = prepare<T, HD>()) return rc;
  if (int rc = tc::info(wkv6_kernel<T, HD>, Cfg<T, HD>::kSmem, out))
    return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], wkv6_kernel<T, HD>, kThreads, Cfg<T, HD>::kSmem));
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

// r, k, v, y: (B, T, H, hd) of the compute dtype (0 float32, 1 bfloat16);
// w: (B, T, H, hd) float32 log-decay <= 0; u: (H, hd) float32; s0, s_out:
// (B, H, hd, hd) float32 (distinct buffers). hd is 32 or 64; T >= 1; every
// operand but u starts on a 16-byte boundary.
extern "C" int aqua_wkv6(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s_out, int B, int T_len, int H,
                         int hd, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, hd, [&](auto t, auto HD) {
    return launch<decltype(t), decltype(HD)::value>(
        r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(s0), y, static_cast<float*>(s_out), B,
        T_len, H, static_cast<cudaStream_t>(stream));
  });
}

// out[0..3]: registers, local bytes (spills and stack), dynamic shared
// memory and resident blocks per SM of the kernel for dtype and hd
extern "C" int aqua_wkv6_info(int dtype, int hd, int* out) {
  return by_type(dtype, hd, [&](auto t, auto HD) {
    return info_of<decltype(t), decltype(HD)::value>(out);
  });
}
