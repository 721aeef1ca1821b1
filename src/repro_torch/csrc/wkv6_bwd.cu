// Backward of the chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no Pallas backward and
// differentiates its jnp chunked form (src/repro/layers/rwkv6.py,
// wkv6_chunked) with jax.grad. This is the backward of csrc/wkv6.cu's
// forward (which replaces wkv6 of src/repro/kernels/rwkv6_wkv/kernel.py)
// behind the port's autograd op; its plain twins, one per pass below, are
// wkv6_bwd_states_plain, wkv6_bwd_dstates_plain and wkv6_bwd_chunk_plain
// in kernels/rwkv6_wkv/ref.py (wkv6_backward_plain composes them). Per
// (sequence b, head h), chunks of C = 32 tokens (the last may be short),
// with S the chunk's entry state, lw the inclusive cumsum of w within the
// chunk, lw_prev[t] = lw[t - 1] (0 at the chunk's first token), a_t =
// e^{lw_prev_t}, D[t,tau] = e^{lw_prev_t - lw_tau} (tau < t), b_tau =
// e^{lw_last - lw_tau}, vdy[t,tau] = v_tau . dy_t and dS the gradient of
// the chunk's exit state:
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
// k b (dS v), Z = e^{lw_last} rowsum(S * dS)).
//
// Bound: at the training shape (B 4, T 2048, H 40, hd 64, bf16 r/k/v/dy and
// dr/dk/dv, f32 w/dw and states) the call must move ~461 MB (~0.14 ms at
// 3.35 TB/s), do ~1.9e10 f32 operations (~0.29 ms at 67 TFLOP/s) and
// ~3.6e8 exponentials, one a causal pair and key dim (~0.10 ms on the
// special-function units): it is bound by its operations. The design below
// also writes and reads two float32 (B, H, nt, hd, hd) scratch tensors
// (~0.20 ms of bytes the bound does not count).
//
// Only two (hd x hd) recurrences are sequential: the entry states going
// forward and the exit-state gradients going back, each independent by
// value-dim column. Given a chunk's S and dS, every gradient of the chunk
// is local to it. So the call is three launches, no tensor cores, all
// arithmetic float32 with explicit fmaf (the build passes -fmad=false):
//
//   1. wkv6_bwd_states_kernel: a block per (b, h) and 32 value dims (320
//      blocks at the training shape, one wave), walking the chunks in order
//      with its (hd x 32) tile of S in registers (4 x 4 a thread) and
//      writing each chunk's entry state to the first scratch. The next
//      chunk's k, v (this block's columns) and w rows are staged by
//      cp.async while the current one computes.
//   2. wkv6_bwd_dstates_kernel: the same template walking the chunks in
//      reverse with dS: writes each chunk's exit gradient to the second
//      scratch, and dstate.
//   3. wkv6_bwd_chunk_kernel: a block of 256 threads per (b, h, chunk)
//      (10,240 blocks, two an SM), every global load issued before the
//      first shared store; products on register tiles (4 rows x hd / 16
//      columns a thread, each 16-byte shared load feeding 8 to 16 fmas,
//      the row operand broadcast across a quarter-warp) for S dy, dS v,
//      (k b)^T dS and vdy; then the causal pairs twice, 31 a thread and 16
//      key dims a half-warp: by row pair (t, 31 - t) for dr's pair sum and
//      A (the latter reduced over the half-warp by a reduce-scatter of 32
//      registers), by column pair for dk's; then A^T dy, the dw scans by
//      warp shuffles and du's share of the chunk, written per (b, h,
//      chunk) for the wrapper to sum. Two exponentials a pair and key dim,
//      not one: a single layout cannot finish both dr's sum over tau and
//      dk's over t in registers.
//
// On the H100 the call takes ~1.2 ms at the training shape: ~0.18 and
// ~0.20 ms in the two state passes, whose reads of w, k or r and scratch
// writes run at ~1.8 TB/s, and ~0.80 ms in the chunk pass, where skipping
// its products or its pairs saves ~0.24 ms each and its loads ~0.08
// (scripts/wkv_bwd_phase_profile.py): no phase dominates at two blocks an
// SM, the most its 110,208 B of shared memory and 128 registers a thread
// allow.
//
// lw is the forward kernel's warp cumsum in log2 units with its running
// minimum (csrc/wkv6.cu), so it is non-increasing in t exactly, every
// exponent is <= 0, and all three passes (and the forward) see the same lw.
// Rows are padded to hd + 4 floats (and raw staged rows by 16 bytes), so
// the lanes of a quarter-warp's 16-byte load land on distinct banks.
// Nothing is summed with atomics: two launches agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using tc::bf16;

constexpr int kChunk = 32;
constexpr int kJT = 32;                       // passes 1, 2: value dims a block
constexpr int kNQ = kJT / 8;                  // and a thread
constexpr int kChunkThreads = 256;            // pass 3
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive values at p (aligned to their size, or to 16 bytes) as float
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

// 16 bytes of T (one uint4) as float
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& x,
                                         float (&o)[16 / sizeof(T)]) {
  const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (std::is_same_v<T, float>) {
      o[e] = __uint_as_float(u[e]);
    } else {
      o[2 * e] = __uint_as_float(u[e] << 16);
      o[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

// The chunk's log-decays in log2 units, as the forward kernel builds them:
// a lane holds tokens 4g .. 4g + 3 (g = lane / 4) of ND key dims, lanes 4
// apart consecutive token groups of the same key dims. On entry x holds w
// (read for every token; those from cn on count as 0), on exit lw: a serial
// sum over the lane's tokens, the groups' totals by __shfl_up_sync, then a
// running minimum over the groups, so lw is non-increasing in t exactly.
// prev0 is lw_prev of token 4g, last lw of the chunk's last token.
template <int ND>
__device__ __forceinline__ void chunk_lw(float (&x)[4][ND], int cn, int lane,
                                         float (&prev0)[ND],
                                         float (&last)[ND]) {
  const int g = lane >> 2, p = lane & 3;
#pragma unroll
  for (int tt = 0; tt < 4; ++tt)
#pragma unroll
    for (int d = 0; d < ND; ++d)
      x[tt][d] = 4 * g + tt < cn ? x[tt][d] * kLog2e : 0.f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
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
}

// -- passes 1 and 2: the two sequential recurrences -------------------------
//
// X' = 2^{lw_last} * X + sum_t p_t^T q_t on a block's (hd x kJT) column tile
// of X, chunk by chunk: pass 1 (forward) X = S, p = k b, q = v; pass 2
// (REV, chunks in reverse) X = dS, p = r a, q = dy. X before each chunk's
// update goes to seq[b, h, chunk]; pass 2 also writes its last X (the
// gradient of the initial state) to x_end. The next chunk's rows are
// staged by cp.async while the current one computes.
template <typename T, int HD>
struct StateCfg {
  static_assert(HD == 32 || HD == 64, "head dims 32 and 64");
  static constexpr int kThreads = 2 * HD;       // a 4 x kNQ tile a thread
  static constexpr int kWarps = kThreads / 32;
  static constexpr int ND = HD / (kWarps * 4);  // cumsum: key dims a lane
  static constexpr int LD = HD + 4;             // padded float row
  static constexpr int kPBytes = HD * sizeof(T) + 16;   // raw p row
  static constexpr int kQBytes = kJT * sizeof(T) + 16;  // raw q columns
  static constexpr int kWBytes = HD * 4 + 16;           // w row
  static constexpr int kStageBytes = kChunk * (kPBytes + kQBytes + kWBytes);
  // float offsets: p as float [C][LD], 2^{lw_last} [HD], then two stages
  static constexpr int oP = 0;
  static constexpr int oDec = kChunk * LD;
  static constexpr int oStage = oDec + HD;
  static constexpr size_t kSmem = sizeof(float) * oStage + 2 * kStageBytes;
  static_assert(ND == 4 && oStage % 4 == 0, "layout");
};

template <typename T, int HD, bool REV>
__device__ __forceinline__ void state_pass(const T* __restrict__ P,
                                           const T* __restrict__ Q,
                                           const float* __restrict__ w,
                                           const float* __restrict__ x0,
                                           float* __restrict__ seq,
                                           float* __restrict__ x_end,
                                           int T_len, int H) {
  using C = StateCfg<T, HD>;
  constexpr int LD = C::LD, ND = C::ND;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem + C::oP;
  float* dec = smem + C::oDec;
  char* stage = reinterpret_cast<char*>(smem + C::oStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NJT = HD / kJT;
  const int bh = blockIdx.x / NJT, j0 = (blockIdx.x % NJT) * kJT;
  const int h = bh % H, tok = H * HD;
  const long long base =
      (static_cast<long long>(bh / H) * T_len * H + h) * HD;
  const int nt = (T_len + kChunk - 1) / kChunk;
  const int n_upd = REV ? nt : nt - 1;          // chunk updates run

  // chunk c's rows of p (all key dims), q (this block's columns) and w
  auto load_stage = [&](int c, int buf) {
    const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
    char* sp = stage + buf * C::kStageBytes;
    char* sq = sp + kChunk * C::kPBytes;
    char* sw = sq + kChunk * C::kQBytes;
    constexpr int E = 16 / sizeof(T);
    constexpr int PP = HD / E, PQ = kJT / E, PW = HD / 4;
    for (int e = tid; e < cn * PP; e += C::kThreads) {
      const int t = e / PP, p = e % PP;
      tc::cp_async16(tc::saddr(sp + t * C::kPBytes + p * 16),
                     P + base + (t0 + t) * tok + p * E, 16);
    }
    for (int e = tid; e < cn * PQ; e += C::kThreads) {
      const int t = e / PQ, p = e % PQ;
      tc::cp_async16(tc::saddr(sq + t * C::kQBytes + p * 16),
                     Q + base + (t0 + t) * tok + j0 + p * E, 16);
    }
    for (int e = tid; e < cn * PW; e += C::kThreads) {
      const int t = e / PW, p = e % PW;
      tc::cp_async16(tc::saddr(sw + t * C::kWBytes + p * 16),
                     w + base + (t0 + t) * tok + 4 * p, 16);
    }
    tc::cp_commit();
  };

  // this thread's tile: rows i0 .. i0 + 3, columns j0 + jc .. + kNQ - 1
  const int i0 = (tid >> 3) * 4, jc = (tid & 7) * kNQ;
  const long long xoff = static_cast<long long>(bh) * HD * HD;
  float X[4][kNQ];
#pragma unroll
  for (int a = 0; a < 4; ++a) load_f(X[a], x0 + xoff + (i0 + a) * HD + j0 + jc);
  if (n_upd > 0) load_stage(REV ? nt - 1 : 0, 0);

  auto store_x = [&](float* dst) {
#pragma unroll
    for (int a = 0; a < 4; ++a) store_f(dst + (i0 + a) * HD + j0 + jc, X[a]);
  };
  for (int n = 0; n < n_upd; ++n) {
    const int c = REV ? nt - 1 - n : n;
    store_x(seq + (static_cast<long long>(bh) * nt + c) * HD * HD);
    const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
    const int buf = n & 1;
    tc::cp_wait<0>();
    __syncthreads();                   // chunk c staged; chunk c -/+ 1 done
    if (n + 1 < n_upd) load_stage(REV ? c - 1 : c + 1, buf ^ 1);
    const char* sp = stage + buf * C::kStageBytes;
    const char* sq = sp + kChunk * C::kPBytes;
    const char* sw = sq + kChunk * C::kQBytes;

    // lw, then p_t = k_t 2^{lw_last - lw_t} (pass 1) or r_t 2^{lw_prev_t}
    // (pass 2) as float rows, zero from cn on, and 2^{lw_last}
    {
      const int g = lane >> 2, p = lane & 3, ip = warp * (4 * ND) + p * ND;
      float x[4][ND], pv[4][ND];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * g + tt;
        load_f(x[tt], reinterpret_cast<const float*>(sw + t * C::kWBytes) + ip);
        load_f(pv[tt], reinterpret_cast<const T*>(sp + t * C::kPBytes) + ip);
      }
      float prev0[ND], last[ND];
      chunk_lw<ND>(x, cn, lane, prev0, last);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * g + tt;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float f = REV ? ex2(tt ? x[tt - 1][d] : prev0[d])
                              : ex2(last[d] - x[tt][d]);
          pv[tt][d] = t < cn ? pv[tt][d] * f : 0.f;
        }
        store_f(ps + t * LD + ip, pv[tt]);
      }
      if (g == 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) dec[ip + d] = ex2(last[d]);
      }
    }
    __syncthreads();

    // X = 2^{lw_last} * X + sum_t p_t^T q_t (a quarter-warp shares its
    // rows, so the p load is a broadcast)
    {
      float dc[4];
      load_f(dc, dec + i0);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < kNQ; ++q) X[a][q] *= dc[a];
#pragma unroll 4
      for (int t = 0; t < cn; ++t) {
        float pp[4], qq[kNQ];
        load_f(pp, ps + t * LD + i0);
        load_f(qq, reinterpret_cast<const T*>(sq + t * C::kQBytes) + jc);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < kNQ; ++q) X[a][q] = fmaf(pp[a], qq[q], X[a][q]);
      }
    }
  }
  // pass 1: the last chunk's entry state; pass 2: the initial state's
  // gradient
  store_x(REV ? x_end + xoff
              : seq + (static_cast<long long>(bh) * nt + nt - 1) * HD * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD)
wkv6_bwd_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ w,
                       const float* __restrict__ s0,
                       float* __restrict__ states, int T_len, int H) {
  state_pass<T, HD, false>(k, v, w, s0, states, nullptr, T_len, H);
}

template <typename T, int HD>
__global__ void __launch_bounds__(2 * HD)
wkv6_bwd_dstates_kernel(const T* __restrict__ r, const T* __restrict__ dy,
                        const float* __restrict__ w,
                        const float* __restrict__ ds_out,
                        float* __restrict__ dstates,
                        float* __restrict__ ds_in, int T_len, int H) {
  state_pass<T, HD, true>(r, dy, w, ds_out, dstates, ds_in, T_len, H);
}

// -- pass 3: every gradient of one chunk ------------------------------------
template <int HD>
struct ChunkCfg {
  static_assert(HD == 32 || HD == 64, "head dims 32 and 64");
  static constexpr int LD = HD + 4;             // padded float row
  static constexpr int CP = kChunk + 4;         // padded (C, C) row
  static constexpr int NI = HD / 16;            // pairs: key dims a thread
  static constexpr int NJ = HD / 16;            // products: columns a thread
  static constexpr int ND = HD / 32;            // cumsum: key dims a lane
  static constexpr int ND2 = HD / 16;           // dw scans: key dims a lane
  static constexpr int kRows = kChunk * LD;
  static constexpr int kSq = HD * LD;
  static constexpr int kFree = 2 * kSq > 3 * kRows ? 2 * kSq : 3 * kRows;
  // float offsets, each a multiple of 4
  static constexpr int oR = 0;
  static constexpr int oK = oR + kRows;
  static constexpr int oV = oK + kRows;
  static constexpr int oDY = oV + kRows;
  static constexpr int oLW = oDY + kRows;       // w, then lw (log2 units)
  static constexpr int oSDY = oLW + kRows;      // S dy [C][LD]
  static constexpr int oDSV = oSDY + kRows;     // dS v [C][LD]
  static constexpr int oKB = oDSV + kRows;      // k b [C][LD], then A [C][CP]
  static constexpr int oVDY = oKB + kRows;      // vdy [C][CP]
  static constexpr int oS = oVDY + kChunk * CP;  // S, dS; then X, YA, YS
  static constexpr int oU = oS + kFree;
  static constexpr int oLast = oU + HD;         // lw_last
  static constexpr int oDec = oLast + HD;       // 2^{lw_last}
  static constexpr int oZ = oDec + HD;
  static constexpr int oAd = oZ + HD;           // A's diagonal [C]
  static constexpr size_t kSmem = sizeof(float) * (oAd + kChunk);
};

// Sum a 32-register vector over the 16 lanes of each half-warp (a
// reduce-scatter: at each step a lane keeps half of its vector and adds the
// partner's copy of that half). After it, element 0 and 1 of the lane with
// bits b3 b2 b1 b0 (of lane & 15) hold the sums of elements 16 b3 + 8 b2 +
// 4 b1 + 2 b0 and the one after it. The order of the sums is fixed.
template <int N>
__device__ __forceinline__ void half_warp_reduce_scatter(float (&acc)[32],
                                                         int lane) {
  if constexpr (N >= 2) {
    constexpr int off = N / 4;         // 8, 4, 2, 1 for N 32, 16, 8, 4
    const bool up = lane & off;
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float send = up ? acc[q] : acc[q + N / 2];
      const float keep = up ? acc[q + N / 2] : acc[q];
      acc[q] = keep + __shfl_xor_sync(kFull, send, off);
    }
    if constexpr (N > 4) half_warp_reduce_scatter<N / 2>(acc, lane);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kChunkThreads, 2)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const T* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      int T_len, int H) {
  using C = ChunkCfg<HD>;
  constexpr int LD = C::LD, CP = C::CP, NI = C::NI, NJ = C::NJ;
  extern __shared__ __align__(16) float smem[];
  float* R = smem + C::oR;
  float* K = smem + C::oK;
  float* V = smem + C::oV;
  float* DY = smem + C::oDY;
  float* LW = smem + C::oLW;
  float* SDY = smem + C::oSDY;
  float* DSV = smem + C::oDSV;
  float* KB = smem + C::oKB;
  float* AS = smem + C::oKB;
  float* VDY = smem + C::oVDY;
  float* S = smem + C::oS;
  float* DS = S + C::kSq;
  float* XS = smem + C::oS;
  float* YAS = XS + C::kRows;
  float* YSS = YAS + C::kRows;
  float* US = smem + C::oU;
  float* LAST = smem + C::oLast;
  float* DEC = smem + C::oDec;
  float* Z = smem + C::oZ;
  float* AD = smem + C::oAd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (T_len + kChunk - 1) / kChunk;
  const int c = blockIdx.x % nt, bh = blockIdx.x / nt, h = bh % H;
  const int t0 = c * kChunk, cn = min(kChunk, T_len - t0);
  const int tok = H * HD;
  const long long base =
      (static_cast<long long>(bh / H) * T_len * H + h) * HD + t0 * tok;
  const long long sq = (static_cast<long long>(bh) * nt + c) * HD * HD;

  // -- the chunk's rows as float (zero from cn on), S, dS and u: every
  // global load issued before the first shared store ----------------------
  {
    constexpr int E = 16 / sizeof(T), PR = HD / E, PW = HD / 4;
    constexpr int NR = (kChunk * PR + kChunkThreads - 1) / kChunkThreads;
    constexpr int NW = (kChunk * PW + kChunkThreads - 1) / kChunkThreads;
    constexpr int NS = HD * HD / 4 / kChunkThreads;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 xr[NR], xk[NR], xv[NR], xy[NR], xw[NW];
    float4 xs[NS], xd[NS];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int e = tid + q * kChunkThreads, t = e / PR;
      const long long o = base + t * tok + (e % PR) * E;
      const bool live = e < kChunk * PR && t < cn;
      xr[q] = live ? *reinterpret_cast<const uint4*>(r + o) : zero;
      xk[q] = live ? *reinterpret_cast<const uint4*>(k + o) : zero;
      xv[q] = live ? *reinterpret_cast<const uint4*>(v + o) : zero;
      xy[q] = live ? *reinterpret_cast<const uint4*>(dy + o) : zero;
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int e = tid + q * kChunkThreads, t = e / PW;
      xw[q] = e < kChunk * PW && t < cn
                  ? *reinterpret_cast<const uint4*>(w + base + t * tok +
                                                    (e % PW) * 4)
                  : zero;
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      xs[q] = reinterpret_cast<const float4*>(states + sq)[tid + q * kChunkThreads];
      xd[q] = reinterpret_cast<const float4*>(dstates + sq)[tid + q * kChunkThreads];
    }
    const float uu = tid < HD ? u[h * HD + tid] : 0.f;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int e = tid + q * kChunkThreads, o = (e / PR) * LD + (e % PR) * E;
      if (e < kChunk * PR) {
        float f[E];
        unpack16<T>(xr[q], f);
        store_f(R + o, f);
        unpack16<T>(xk[q], f);
        store_f(K + o, f);
        unpack16<T>(xv[q], f);
        store_f(V + o, f);
        unpack16<T>(xy[q], f);
        store_f(DY + o, f);
      }
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int e = tid + q * kChunkThreads;
      if (e < kChunk * PW) {
        float f[4];
        unpack16<float>(xw[q], f);
        store_f(LW + (e / PW) * LD + (e % PW) * 4, f);
      }
    }
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int e = tid + q * kChunkThreads, o = (e / PW) * LD + (e % PW) * 4;
      *reinterpret_cast<float4*>(S + o) = xs[q];
      *reinterpret_cast<float4*>(DS + o) = xd[q];
    }
    if (tid < HD) US[tid] = uu;
  }
  __syncthreads();

  // -- lw in place, k b, 2^{lw_last} ---------------------------------------
  {
    constexpr int ND = C::ND;
    const int g = lane >> 2, p = lane & 3, ip = warp * (4 * ND) + p * ND;
    float x[4][ND], kk[4][ND], prev0[ND], last[ND];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      load_f(x[tt], LW + (4 * g + tt) * LD + ip);
      load_f(kk[tt], K + (4 * g + tt) * LD + ip);
    }
    chunk_lw<ND>(x, cn, lane, prev0, last);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int d = 0; d < ND; ++d) kk[tt][d] *= ex2(last[d] - x[tt][d]);
      store_f(LW + (4 * g + tt) * LD + ip, x[tt]);
      store_f(KB + (4 * g + tt) * LD + ip, kk[tt]);
    }
    if (g == 0) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        LAST[ip + d] = last[d];
        DEC[ip + d] = ex2(last[d]);
      }
    }
  }
  __syncthreads();

  // -- products on register tiles: rows 4 tb .. 4 tb + 3; a quarter-warp
  // shares tb (its row loads are broadcasts) and takes 8 consecutive
  // column slots ------------------------------------------------------------
  const int pt = tid & 127;
  const int slot = (pt & 7) + 8 * ((pt >> 5) & 1);
  const int tb = ((pt >> 3) & 3) + 4 * (pt >> 6);
  float dv2[4][NJ];                    // (k b)^T dS, kept for dv
  if (tid < 128) {
    // S dy_t and dS v_t at key dims slot + 16 q (rows 8 apart in a
    // quarter-warp: distinct banks)
    float sdy[4][NJ], dsv[4][NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < NJ; ++q) sdy[a][q] = dsv[a][q] = 0.f;
#pragma unroll 2
    for (int j = 0; j < HD; j += 4) {
      float yr[4][4], vr[4][4], sr[NJ][4], dr_[NJ][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load_f(yr[a], DY + (4 * tb + a) * LD + j);
        load_f(vr[a], V + (4 * tb + a) * LD + j);
      }
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        load_f(sr[q], S + (slot + 16 * q) * LD + j);
        load_f(dr_[q], DS + (slot + 16 * q) * LD + j);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < NJ; ++q) {
            sdy[a][q] = fmaf(yr[a][e], sr[q][e], sdy[a][q]);
            dsv[a][q] = fmaf(vr[a][e], dr_[q][e], dsv[a][q]);
          }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        SDY[(4 * tb + a) * LD + slot + 16 * q] = sdy[a][q];
        DSV[(4 * tb + a) * LD + slot + 16 * q] = dsv[a][q];
      }
  } else {
    // (k b)^T dS at value dims slot * NJ .. (consecutive)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < NJ; ++q) dv2[a][q] = 0.f;
#pragma unroll 2
    for (int i = 0; i < HD; i += 4) {
      float kb[4][4], dsr[4][NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) load_f(kb[a], KB + (4 * tb + a) * LD + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) load_f(dsr[e], DS + (i + e) * LD + slot * NJ);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < NJ; ++q)
            dv2[a][q] = fmaf(kb[a][e], dsr[e][q], dv2[a][q]);
    }
    // vdy[t][tau] at tau = slot, slot + 16
    float vd[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) vd[a][0] = vd[a][1] = 0.f;
#pragma unroll 2
    for (int j = 0; j < HD; j += 4) {
      float yr[4][4], vr[2][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) load_f(yr[a], DY + (4 * tb + a) * LD + j);
#pragma unroll
      for (int q = 0; q < 2; ++q) load_f(vr[q], V + (slot + 16 * q) * LD + j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            vd[a][q] = fmaf(yr[a][e], vr[q][e], vd[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        VDY[(4 * tb + a) * CP + slot + 16 * q] = vd[a][q];
    // Z = 2^{lw_last} rowsum(S * dS) and A's diagonal, r_t . (u * k_t)
    if (pt < HD) {
      float z = 0.f;
#pragma unroll 4
      for (int j = 0; j < HD; j += 4) {
        float sr[4], dr_[4];
        load_f(sr, S + pt * LD + j);
        load_f(dr_, DS + pt * LD + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) z = fmaf(sr[e], dr_[e], z);
      }
      Z[pt] = DEC[pt] * z;
    } else if (pt >= 64 && pt < 64 + kChunk) {
      const int t = pt - 64;
      float a = 0.f;
#pragma unroll 4
      for (int i = 0; i < HD; i += 4) {
        float rr[4], uu[4], kk[4];
        load_f(rr, R + t * LD + i);
        load_f(uu, US + i);
        load_f(kk, K + t * LD + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) a = fmaf(rr[e] * uu[e], kk[e], a);
      }
      AD[t] = a;
    }
  }
  __syncthreads();

  // -- the causal pairs: a half-warp takes row pair (31 - l, l) or column
  // pair (l, 31 - l), 31 pairs, over its 16 lanes' NI key dims each ------
  {
    const int ig = lane & 15, l = tid >> 4, i0 = ig * NI;
    const int hi = 31 - l, nhi = 31 - l;
    float ui[NI];
    load_f(ui, US + i0);
    // rows: slot s < nhi is (hi, tau = s), else (l, tau = s - nhi)
    {
      float lph[NI], lpl[NI], rh[NI], rl[NI], prh[NI], prl[NI], acc[32];
      load_f(lph, LW + (hi - 1) * LD + i0);
      load_f(rh, R + hi * LD + i0);
      load_f(rl, R + l * LD + i0);
      if (l > 0) {
        load_f(lpl, LW + (l - 1) * LD + i0);
      } else {
#pragma unroll
        for (int q = 0; q < NI; ++q) lpl[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < NI; ++q) prh[q] = prl[q] = 0.f;
#pragma unroll
      for (int s = 0; s < 31; ++s) {
        const bool up = s < nhi;
        const int t = up ? hi : l, tau = up ? s : s - nhi;
        float lt[NI], kt[NI];
        load_f(lt, LW + tau * LD + i0);
        load_f(kt, K + tau * LD + i0);
        const float vd = VDY[t * CP + tau];
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          const float e = ex2((up ? lph[q] : lpl[q]) - lt[q]);
          const float ev = e * vd;
          if (up) {
            prh[q] = fmaf(ev, kt[q], prh[q]);
          } else {
            prl[q] = fmaf(ev, kt[q], prl[q]);
          }
          a = fmaf(e, (up ? rh[q] : rl[q]) * kt[q], a);
        }
        acc[s] = a;
      }
      acc[31] = 0.f;
      half_warp_reduce_scatter<32>(acc, lane);
      const int sk = 16 * ((ig >> 3) & 1) + 8 * ((ig >> 2) & 1) +
                     4 * ((ig >> 1) & 1) + 2 * (ig & 1);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int s = sk + q;
        if (s < 31) {
          const bool up = s < nhi;
          const int t = up ? hi : l, tau = up ? s : s - nhi;
          AS[t * CP + tau] = acc[q];
          AS[tau * CP + t] = 0.f;
        } else {
          AS[hi * CP + hi] = AD[hi];
          AS[l * CP + l] = AD[l];
        }
      }
      // dr and X for rows hi and l
      auto row_out = [&](int t, const float (&lp)[NI], const float (&rr)[NI],
                         const float (&pr)[NI]) {
        float sd[NI], kr[NI], drv[NI], xv[NI];
        load_f(sd, SDY + t * LD + i0);
        load_f(kr, K + t * LD + i0);
        const float vdd = VDY[t * CP + t];
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          const float x = ex2(lp[q]) * sd[q] + pr[q];
          drv[q] = x + ui[q] * kr[q] * vdd;
          xv[q] = rr[q] * x;
        }
        if (t < cn) store_f(dr + base + t * tok + i0, drv);
        store_f(XS + t * LD + i0, xv);
      };
      row_out(hi, lph, rh, prh);
      row_out(l, lpl, rl, prl);
    }
    // columns: slot s < nhi is (tau = l, t = l + 1 + s), else (tau = 31 -
    // l, t = s + 1)
    {
      float lwl[NI], lwh[NI], pkl[NI], pkh[NI];
      load_f(lwl, LW + l * LD + i0);
      load_f(lwh, LW + hi * LD + i0);
#pragma unroll
      for (int q = 0; q < NI; ++q) pkl[q] = pkh[q] = 0.f;
#pragma unroll 4
      for (int s = 0; s < 31; ++s) {
        const bool lo = s < nhi;
        const int t = lo ? l + 1 + s : s + 1, tau = lo ? l : hi;
        float lp[NI], rr[NI];
        load_f(lp, LW + (t - 1) * LD + i0);
        load_f(rr, R + t * LD + i0);
        const float vd = VDY[t * CP + tau];
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          const float ev = ex2(lp[q] - (lo ? lwl[q] : lwh[q])) * vd;
          if (lo) {
            pkl[q] = fmaf(ev, rr[q], pkl[q]);
          } else {
            pkh[q] = fmaf(ev, rr[q], pkh[q]);
          }
        }
      }
      // dk, YA and YS for columns l and 31 - l
      float lst[NI];
      load_f(lst, LAST + i0);
      auto col_out = [&](int tau, const float (&lw_)[NI],
                         const float (&pk)[NI]) {
        float kk[NI], rr[NI], dsv[NI], dkv[NI], ya[NI], ys[NI];
        load_f(kk, K + tau * LD + i0);
        load_f(rr, R + tau * LD + i0);
        load_f(dsv, DSV + tau * LD + i0);
        const float vdd = VDY[tau * CP + tau];
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          const float bds = ex2(lst[q] - lw_[q]) * dsv[q];
          dkv[q] = pk[q] + ui[q] * rr[q] * vdd + bds;
          ya[q] = kk[q] * pk[q];
          ys[q] = kk[q] * bds;
        }
        if (tau < cn) store_f(dk + base + tau * tok + i0, dkv);
        store_f(YAS + tau * LD + i0, ya);
        store_f(YSS + tau * LD + i0, ys);
      };
      col_out(l, lwl, pkl);
      col_out(hi, lwh, pkh);
    }
  }
  __syncthreads();

  if (tid >= 128) {
    // dv = A^T dy + (k b)^T dS (A's upper triangle is zero)
    float dv1[4][NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < NJ; ++q) dv1[a][q] = 0.f;
#pragma unroll 2
    for (int t = 4 * tb; t < kChunk; ++t) {
      float at[4], yr[NJ];
      load_f(at, AS + t * CP + 4 * tb);
      load_f(yr, DY + t * LD + slot * NJ);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < NJ; ++q) dv1[a][q] = fmaf(at[a], yr[q], dv1[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int tau = 4 * tb + a;
      float o[NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q) o[q] = dv1[a][q] + dv2[a][q];
      if (tau < cn) store_f(dv + base + tau * tok + slot * NJ, o);
    }
  } else {
    // dw_s = sum_{t>s} X_t - sum_{t>=s} YA_t + sum_{t<s} YS_t + Z, and the
    // chunk's share of du: a lane holds tokens 4g .. 4g + 3 of ND2 key dims
    constexpr int ND2 = C::ND2;
    const int g = lane >> 2, p = lane & 3, ip = warp * (4 * ND2) + p * ND2;
    float xs[4][ND2], ya[4][ND2], ys[4][ND2], z[ND2], du[ND2];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = 4 * g + tt;
      load_f(xs[tt], XS + t * LD + ip);
      load_f(ya[tt], YAS + t * LD + ip);
      load_f(ys[tt], YSS + t * LD + ip);
    }
    load_f(z, Z + ip);
#pragma unroll
    for (int d = 0; d < ND2; ++d) du[d] = 0.f;
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = 4 * g + tt;
      float rr[ND2], kk[ND2];
      load_f(rr, R + t * LD + ip);
      load_f(kk, K + t * LD + ip);
      const float vdd = VDY[t * CP + t];
#pragma unroll
      for (int d = 0; d < ND2; ++d) du[d] = fmaf(rr[d] * kk[d], vdd, du[d]);
    }
    float out[4][ND2];
#pragma unroll
    for (int d = 0; d < ND2; ++d) {
      // suffix sums (t >= s) of X and YA, prefix sum (t < s) of YS: serial
      // within the lane, then the groups' totals by shuffles
      float sx[4], sa[4], py[4];
      sx[3] = xs[3][d];
      sa[3] = ya[3][d];
#pragma unroll
      for (int tt = 2; tt >= 0; --tt) {
        sx[tt] = sx[tt + 1] + xs[tt][d];
        sa[tt] = sa[tt + 1] + ya[tt][d];
      }
      py[0] = 0.f;
#pragma unroll
      for (int tt = 1; tt < 4; ++tt) py[tt] = py[tt - 1] + ys[tt - 1][d];
      float tx = sx[0], ta = sa[0], ty = py[3] + ys[3][d];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ox = __shfl_down_sync(kFull, tx, off);
        const float oa = __shfl_down_sync(kFull, ta, off);
        const float oy = __shfl_up_sync(kFull, ty, off);
        if (lane + off < 32) {
          tx += ox;
          ta += oa;
        }
        if (lane >= off) ty += oy;
      }
      float ex = __shfl_down_sync(kFull, tx, 4);
      float ea = __shfl_down_sync(kFull, ta, 4);
      float ey = __shfl_up_sync(kFull, ty, 4);
      if (g == 7) ex = ea = 0.f;
      if (g == 0) ey = 0.f;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
        out[tt][d] = ((sx[tt] + ex) - xs[tt][d]) - (sa[tt] + ea) +
                     (py[tt] + ey) + z[d];
      // du over the 8 token groups
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        du[d] += __shfl_xor_sync(kFull, du[d], off);
    }
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int t = 4 * g + tt;
      if (t < cn) store_f(dw + base + t * tok + ip, out[tt]);
    }
    if (g == 0) store_f(du_part + (static_cast<long long>(bh) * nt + c) * HD + ip, du);
  }
}

template <typename T, int HD>
int prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_states_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(StateCfg<T, HD>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_dstates_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(StateCfg<T, HD>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ChunkCfg<HD>::kSmem));
  return static_cast<int>(err);
}

// registers, local bytes, dynamic shared memory and resident blocks per SM
template <typename KernelT>
int info_one(KernelT kernel, int threads, size_t smem, int* out) {
  if (int rc = tc::info(kernel, smem, out)) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], kernel, threads, smem));
}

template <typename T, int HD>
int info_of(int* out) {
  if (int rc = prepare<T, HD>()) return rc;
  constexpr size_t ss = StateCfg<T, HD>::kSmem, cs = ChunkCfg<HD>::kSmem;
  if (int rc = info_one(wkv6_bwd_states_kernel<T, HD>, 2 * HD, ss, out))
    return rc;
  if (int rc = info_one(wkv6_bwd_dstates_kernel<T, HD>, 2 * HD, ss, out + 4))
    return rc;
  return info_one(wkv6_bwd_chunk_kernel<T, HD>, kChunkThreads, cs, out + 8);
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
// ds_out, ds_in: (B, H, hd, hd) float32; states, dstates: (B, H, ceil(T /
// 32), hd, hd) float32, each chunk's entry state and exit-state gradient;
// du_part: (B, H, ceil(T / 32), hd) float32, each chunk's du, which the
// caller sums. passes: bit 0 runs pass 1 (k, v, w, s0 -> states), bit 1
// pass 2 (r, w, dy, ds_out -> dstates, ds_in), bit 2 pass 3 (r, k, v, w, u,
// dy, states, dstates -> dr, dk, dv, dw, du_part); a pass not run may get
// null for what only it reads or writes. hd is 32 or 64; T >= 1; r, k, v,
// w, dy and the outputs start on a 16-byte boundary. Returns the first
// launch's error.
extern "C" int aqua_wkv6_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* ds_out, void* dr,
                             void* dk, void* dv, void* dw, void* du_part,
                             void* ds_in, void* states, void* dstates, int B,
                             int T_len, int H, int hd, int dtype, int passes,
                             void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, hd, [&](auto t, auto HDc) {
    using T = decltype(t);
    constexpr int HD = decltype(HDc)::value;
    if (int rc = prepare<T, HD>()) return rc;
    const auto st = static_cast<cudaStream_t>(stream);
    const int nt = (T_len + kChunk - 1) / kChunk;
    const int state_blocks = B * H * (HD / kJT);
    constexpr size_t ss = StateCfg<T, HD>::kSmem;
    if (passes & 1) {
      wkv6_bwd_states_kernel<T, HD><<<state_blocks, 2 * HD, ss, st>>>(
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(w), static_cast<const float*>(s0),
          static_cast<float*>(states), T_len, H);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    if (passes & 2) {
      wkv6_bwd_dstates_kernel<T, HD><<<state_blocks, 2 * HD, ss, st>>>(
          static_cast<const T*>(r), static_cast<const T*>(dy),
          static_cast<const float*>(w), static_cast<const float*>(ds_out),
          static_cast<float*>(dstates), static_cast<float*>(ds_in), T_len,
          H);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    if (passes & 4) {
      wkv6_bwd_chunk_kernel<T, HD>
          <<<B * H * nt, kChunkThreads, ChunkCfg<HD>::kSmem, st>>>(
              static_cast<const T*>(r), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const float*>(w),
              static_cast<const float*>(u), static_cast<const T*>(dy),
              static_cast<const float*>(states),
              static_cast<const float*>(dstates), static_cast<T*>(dr),
              static_cast<T*>(dk), static_cast<T*>(dv),
              static_cast<float*>(dw), static_cast<float*>(du_part), T_len,
              H);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    return 0;
  });
}

// out[0..11]: per pass (states, dstates, chunk) the registers, local bytes
// (spills and stack), dynamic shared memory and resident blocks per SM of
// its kernel for dtype and hd
extern "C" int aqua_wkv6_bwd_info(int dtype, int hd, int* out) {
  return by_type(dtype, hd, [&](auto t, auto HDc) {
    return info_of<decltype(t), decltype(HDc)::value>(out);
  });
}
