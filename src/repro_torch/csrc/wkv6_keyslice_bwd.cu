// The backward of the RWKV-6 WKV recurrence over a key slice of the state,
// for Hopper (sm_90a).
//
// The partitioned train step (layers/rwkv6.py, rwkv_train_sharded) holds a
// rank's key rows of every head's state: S in R^{K x V}, K of the head's
// V key dims (rwkv6-3b on pod256: K 4 of 64). The forward is
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
// take. Its plain twins, one per pass: wkv6_bwd_states_plain and
// wkv6_bwd_dstates_plain (passes 1 + 2; wkv6_keyslice_sums_plain and
// wkv6_keyslice_scan_plain each alone) and wkv6_bwd_chunk_plain (pass 3),
// in kernels/rwkv6_wkv/ref.py.
//
// Design: chunks of 32 tokens (the last may be short), all at once:
//   1. sums_kernel (csrc/wkv6_keyslice.cuh): each chunk's d_c, Delta_c and
//      Gamma_c, the forward and reverse recurrences from zero;
//   2. scan_kernel: a thread per state entry and direction, each chunk's
//      entry state S and exit-state gradient dS (and ds_in);
//   3. bwd_chunk_kernel: a block of 256 threads per (b, h, chunk), every
//      chunk at once (~20,000 blocks at rwkv6-3b's train micro-batch).
//      Its global loads all issue first; dy . v and sum_i r u k of each
//      token are summed from the registers that hold its rows. Then half
//      the threads, a value column and a few key rows each, recompute the
//      states S_{t-1} of the chunk's tokens from S into shared memory,
//      while the other half walk dS_t back from the exit gradient into
//      shared memory. The sums over value columns (dr, dk, dw) are then dot
//      products by (token, key row) from shared memory, with no per-token
//      shuffles, and dv sums over key rows by (token, column). Key rows go
//      through in groups (256 / V state entries a token). du is written
//      per (b, h, chunk) and summed by the wrapper in a fixed order: no
//      atomics, so two launches agree bit for bit.
// A call of at most 32 tokens is pass 3 alone from s0 and ds_out.
//
// Bound: at rwkv6-3b's pod256 rank shapes (K 4, V 64, bf16 r/k/v/dy), a
// token moves r, k, dr, dk (2 K bytes each), w and dw (4 K), v, dy and dv
// (2 V) a head: 448 bytes, against ~14 K V float32 operations, so the
// bytes set the bound. This design reads the inputs twice (passes 1 and 3)
// and writes and reads two (B, H, nt, K, V) float32 scratch tensors of
// chunk states, which the bound does not count. What holds pass 3 is its
// shared-memory traffic: a block writes the chunk's states and their
// gradients (64 KiB at K 4) and reads them back, and a phase of it
// waits on the one before; so every shared load that can is 8 or 16
// bytes wide (scripts/wkv_bwd_phase_profile.py --keyslice times each
// phase).
// Float32 throughout with explicit fmaf (the build passes -fmad=false).
#include "wkv6_keyslice.cuh"

namespace {

using ks::bf16;
using ks::kChunk;

// pass 3's shape: 256 threads; key rows go through in groups of KG (256
// / V a group); each column's walk in either direction is split over RS
// threads of KW rows; a sum over the value columns of a (token, key row)
// is split over TPP threads of JP columns each; dv's running sum over the
// groups is kDvItems registers a thread. Its shared memory, in floats: the
// states and their gradients of a group ([kChunk][KG][V] each), r, k and
// e^w by key row ([K][kRow] each: a walker reads four tokens of a row in
// one 16-byte load), dy . v and sum_i r u k a token, u (K, padded to 16
// bytes), then v and dy ([kChunk][V] of T each). The block is bound by
// its shared-memory traffic (the states it writes and reads back), so
// every load that can is 8 or 16 bytes.
template <typename T, int K, int V>
struct ChunkCfg {
  static constexpr int kThreads = 256;
  static constexpr int KG = K < kThreads / V ? K : kThreads / V;
  static constexpr int G = K / KG;
  static constexpr int RS =
      kThreads / (2 * V) < KG ? kThreads / (2 * V) : KG;
  static constexpr int KW = KG / RS;
  static constexpr int TPP =
      kThreads / (kChunk * KG) > 1 ? kThreads / (kChunk * KG) : 1;
  static constexpr int JP = V / TPP;
  static constexpr int kDvItems = kChunk * V / kThreads;
  static constexpr int kRow = kChunk + 4;
  static constexpr int kSS = 0;
  static constexpr int kSDS = kSS + kChunk * KG * V;
  static constexpr int kKeys = kSDS + kChunk * KG * V;
  static constexpr int kTok = kKeys + 3 * K * kRow;
  static constexpr int kU = kTok + 2 * kChunk;
  static constexpr int kVals = kU + (K + 3) / 4 * 4;
  static constexpr size_t kSmem =
      kVals * sizeof(float) + 2 * kChunk * V * sizeof(T);
};

// two adjacent values of a shared row as float
__device__ __forceinline__ float2 pair_of(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_of(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// -- pass 3: every gradient of each chunk ------------------------------------
// states, dstates: (B, H, nt, K, V) float32, each chunk's entry state and
// exit-state gradient (s0 and ds_out themselves when nt == 1); du_part:
// (B, H, nt, K); ds_in (when not null) gets chunk 0's entry-state gradient.
template <typename T, int K, int V>
__global__ void __launch_bounds__(256)
    bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const T* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, T* __restrict__ dr,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds_in, int T_len, int H, int nt) {
  using C = ChunkCfg<T, K, V>;
  constexpr int KG = C::KG, KW = C::KW, NT = C::kThreads;
  constexpr int TPP = C::TPP, JP = C::JP, kRow = C::kRow;
  constexpr int kBatch = 8;                  // tokens a walker's batch
  extern __shared__ __align__(16) float smem[];
  auto ss = reinterpret_cast<float(*)[KG][V]>(smem + C::kSS);
  auto sds = reinterpret_cast<float(*)[KG][V]>(smem + C::kSDS);
  auto sr = reinterpret_cast<float(*)[kRow]>(smem + C::kKeys);
  auto sk = sr + K;
  auto sd = sk + K;
  float* dyv = smem + C::kTok;
  float* ruk = dyv + kChunk;
  float* su = smem + C::kU;
  auto sv = reinterpret_cast<T(*)[V]>(smem + C::kVals);
  auto sdy = sv + kChunk;

  const ks::Chunk ch = ks::chunk_of<K, V>(T_len, H, nt);
  const int tid = threadIdx.x, lane = tid & 31;
  // walkers: RS a column forward, RS in reverse, KW rows each
  const int walker = tid / V, j = tid % V;
  const bool walks = walker < 2 * C::RS, reverse = walker >= C::RS;
  const int q0 = (walker % C::RS) * KW;        // first row in a group
  // every global load of the block issues before its first shared store:
  // the chunk's rows, u, each walker's rows of the entry state (or of the
  // exit-state gradient) in every group. dy . v and sum_i r u k of each
  // token are summed from the registers, over the lanes that hold its row
  float init[C::G][KW];
  {
    using Keys = ks::KeyRows<K, NT>;
    using Vals = ks::ValueRows<T, V, NT>;
    Keys rr, kk, ww;
    Vals vv, yy;
    float uu[Keys::kLoads];
    rr.load(r, ch, H, tid);
    kk.load(k, ch, H, tid);
    ww.load(w, ch, H, tid);
    vv.load(v, ch, H, tid);
    yy.load(dy, ch, H, tid);
#pragma unroll
    for (int e = 0; e < Keys::kLoads; ++e)
      uu[e] = u[ch.h * K + (tid + e * NT) % K];
    if (walks) {
      const float* from = (reverse ? dstates : states) + ch.bhc * K * V + j;
#pragma unroll
      for (int g = 0; g < C::G; ++g)
#pragma unroll
        for (int q = 0; q < KW; ++q)
          init[g][q] = from[(g * KG + q0 + q) * V];
    }
#pragma unroll
    for (int e = 0; e < Keys::kLoads; ++e) {
      const int at = tid + e * NT, t = at / K, i = at % K;
      const bool live = at < ch.n * K;
      float x = live ? rr.x[e] * uu[e] * kk.x[e] : 0.f;
#pragma unroll
      for (int o = 1; o < K; o <<= 1) x += __shfl_xor_sync(ks::kFull, x, o);
      if (live) {
        sr[i][t] = rr.x[e];
        sk[i][t] = kk.x[e];
        sd[i][t] = expf(ww.x[e]);
        if (i == 0) ruk[t] = x;
      }
    }
#pragma unroll
    for (int e = 0; e < Vals::kLoads; ++e) {
      float x = vv.dot(yy, ch, tid, e);
#pragma unroll
      for (int o = 1; o < Vals::kPer; o <<= 1)
        x += __shfl_xor_sync(ks::kFull, x, o);
      const int at = tid + e * NT;
      if (at < ch.n * Vals::kPer && at % Vals::kPer == 0)
        dyv[at / Vals::kPer] = x;
    }
    vv.store(sv, ch, tid);
    yy.store(sdy, ch, tid);
    if (tid < K) su[tid] = u[ch.h * K + tid];
  }
  __syncthreads();

  float dvacc[C::kDvItems];
#pragma unroll
  for (int g = 0; g < C::G; ++g) {
    const int i0 = g * KG + q0;
    if (walks && !reverse) {
      // S_{t-1} of each token of the chunk, from its entry state; a batch
      // of kBatch tokens' loads issue before its stores
      float s[KW];
#pragma unroll
      for (int q = 0; q < KW; ++q) s[q] = init[g][q];
      for (int t0 = 0; t0 < ch.n; t0 += kBatch) {
        float vj[kBatch], dd[KW][kBatch], kk[KW][kBatch];
#pragma unroll
        for (int x = 0; x < kBatch; ++x) vj[x] = ks::to_f(sv[t0 + x][j]);
#pragma unroll
        for (int q = 0; q < KW; ++q)
#pragma unroll
          for (int x = 0; x < kBatch; x += 4) {
            *reinterpret_cast<float4*>(&dd[q][x]) =
                *reinterpret_cast<const float4*>(&sd[i0 + q][t0 + x]);
            *reinterpret_cast<float4*>(&kk[q][x]) =
                *reinterpret_cast<const float4*>(&sk[i0 + q][t0 + x]);
          }
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
          if (t0 + x < ch.n) {
#pragma unroll
            for (int q = 0; q < KW; ++q) {
              ss[t0 + x][q0 + q][j] = s[q];
              s[q] = fmaf(dd[q][x], s[q], kk[q][x] * vj[x]);
            }
          }
        }
      }
    } else if (walks) {
      // dS_t of each token from the exit gradient, in reverse, a batch of
      // kBatch tokens at a time from the last
      float gs[KW];
#pragma unroll
      for (int q = 0; q < KW; ++q) gs[q] = init[g][q];
      for (int t0 = (ch.n - 1) / kBatch * kBatch; t0 >= 0; t0 -= kBatch) {
        float yj[kBatch], dd[KW][kBatch], rq[KW][kBatch];
#pragma unroll
        for (int x = 0; x < kBatch; ++x) yj[x] = ks::to_f(sdy[t0 + x][j]);
#pragma unroll
        for (int q = 0; q < KW; ++q)
#pragma unroll
          for (int x = 0; x < kBatch; x += 4) {
            *reinterpret_cast<float4*>(&dd[q][x]) =
                *reinterpret_cast<const float4*>(&sd[i0 + q][t0 + x]);
            *reinterpret_cast<float4*>(&rq[q][x]) =
                *reinterpret_cast<const float4*>(&sr[i0 + q][t0 + x]);
          }
#pragma unroll
        for (int x = kBatch - 1; x >= 0; --x) {
          if (t0 + x < ch.n) {
#pragma unroll
            for (int q = 0; q < KW; ++q) {
              sds[t0 + x][q0 + q][j] = gs[q];
              gs[q] = fmaf(dd[q][x], gs[q], rq[q][x] * yj[x]);
            }
          }
        }
      }
      if (ds_in != nullptr && ch.c == 0) {
#pragma unroll
        for (int q = 0; q < KW; ++q)
          ds_in[(ch.bh * K + i0 + q) * V + j] = gs[q];
      }
    }
    __syncthreads();
    const int g0 = g * KG;
    // the sums over value columns of each (token, key row): TPP threads of
    // JP columns each, two columns a load, each thread starting at its lane
    // so that a half-warp's 8-byte loads fall on 32 banks
    for (int p0 = 0; p0 < ch.n * KG; p0 += NT / TPP) {
      const int p = p0 + tid / TPP, h = tid % TPP;
      const bool live = p < ch.n * KG;
      const int t = live ? p / KG : 0, q = p % KG;
      float a = 0.f, b = 0.f, c = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < JP / 2; ++jj) {
        const int x = h * JP + 2 * ((jj + lane) & (JP / 2 - 1));
        const float2 sp = pair_of(&ss[t][q][x]);
        const float2 gp = pair_of(&sds[t][q][x]);
        const float2 yp = pair_of(&sdy[t][x]), vp = pair_of(&sv[t][x]);
        a = fmaf(yp.y, sp.y, fmaf(yp.x, sp.x, a));
        b = fmaf(gp.y, vp.y, fmaf(gp.x, vp.x, b));
        c = fmaf(sp.y, gp.y, fmaf(sp.x, gp.x, c));
      }
#pragma unroll
      for (int o = 1; o < TPP; o <<= 1) {
        a += __shfl_xor_sync(ks::kFull, a, o);
        b += __shfl_xor_sync(ks::kFull, b, o);
        c += __shfl_xor_sync(ks::kFull, c, o);
      }
      if (live && h == 0) {
        const int i = g0 + q;
        const float ui = su[i];
        const long long at =
            ch.key0 + static_cast<long long>(t) * H * K + i;
        dr[at] = ks::from_f<T>(fmaf(ui * sk[i][t], dyv[t], a));
        dk[at] = ks::from_f<T>(fmaf(sr[i][t] * ui, dyv[t], b));
        dw[at] = sd[i][t] * c;
      }
    }
    // dv_t[j] = sum_i dS_t[i][j] k_t[i] + (sum_i r_t u k_t) dy_t[j], the
    // group's rows added to the earlier groups' in registers
#pragma unroll
    for (int m = 0; m < C::kDvItems; ++m) {
      const int t = (tid + m * NT) / V, x = (tid + m * NT) % V;
      if (t >= ch.n) continue;
      float acc = g == 0 ? ruk[t] * ks::to_f(sdy[t][x]) : dvacc[m];
#pragma unroll
      for (int q = 0; q < KG; ++q)
        acc = fmaf(sds[t][q][x], sk[g0 + q][t], acc);
      dvacc[m] = acc;
      if (g == C::G - 1)
        dv[ch.val0 + static_cast<long long>(t) * H * V + x] =
            ks::from_f<T>(acc);
    }
    __syncthreads();
  }
  if (tid < K) {
    float x = 0.f;
    for (int t = 0; t < ch.n; ++t)
      x = fmaf(sr[tid][t] * sk[tid][t], dyv[t], x);
    du_part[ch.bhc * K + tid] = x;
  }
}

template <typename T, int K, int V>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      bwd_chunk_kernel<T, K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ChunkCfg<T, K, V>::kSmem)));
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
  if (dtype == 1) return keys(bf16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, dr, dk: (B, T, H, K) and v, dy, dv: (B, T, H, V) of the compute
// dtype (0 float32, 1 bfloat16); w, dw: (B, T, H, K) float32; u: (H, K)
// float32; s0, ds_out, ds_in: (B, H, K, V) float32; du_part: (B, H, nt,
// K) float32, each chunk's du, which the caller sums; d: (B, H, nt, K),
// states and dstates: (B, H, nt, K, V) float32 scratch, nt = ceil(T / 32).
// passes: bit 0 runs pass 1 (k, v, w -> d, Delta into states; r, dy ->
// Gamma into dstates), bit 1 pass 2 (both ways: s0 -> each chunk's entry
// state, and ds_out -> each chunk's exit-state gradient, the initial
// state's into ds_in), bit 2 pass 3 (r, k, v, w, u, dy, states, dstates ->
// dr, dk, dv, dw, du_part, and, when pass 2 does not run, chunk 0's
// entry-state gradient into ds_in if it is not null); a pass not run may
// get null for what only it touches. With nt == 1 pass 3 alone may take
// s0 and ds_out as states and dstates. v and dy start on a 16-byte
// boundary. V is 32 or 64 and K a power of two from 1 to 16 below it; T
// >= 1. Returns the first launch's error.
extern "C" int aqua_wkv6_keyslice_bwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds_in,
    void* d, void* states, void* dstates, int B, int T_len, int H, int K,
    int V, int dtype, int passes, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    using T = decltype(t);
    constexpr int KK = decltype(KC)::value, VV = decltype(VC)::value;
    const auto st = static_cast<cudaStream_t>(stream);
    const int nt = (T_len + kChunk - 1) / kChunk;
    const int blocks = B * H * nt;
    if (passes & 1) {
      ks::sums_kernel<T, KK, VV, true><<<blocks, 2 * VV, 0, st>>>(
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(w), static_cast<const T*>(r),
          static_cast<const T*>(dy), static_cast<float*>(d),
          static_cast<float*>(states), static_cast<float*>(dstates), T_len,
          H, nt);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    if (passes & 2) {
      if (int rc = ks::launch_scan<KK, VV>(
              static_cast<const float*>(d), static_cast<const float*>(s0),
              static_cast<float*>(states), static_cast<const float*>(ds_out),
              static_cast<float*>(dstates), static_cast<float*>(ds_in), B,
              H, nt, st))
        return rc;
    }
    if (passes & 4) {
      if (int rc = prepare<T, KK, VV>()) return rc;
      bwd_chunk_kernel<T, KK, VV>
          <<<blocks, 256, ChunkCfg<T, KK, VV>::kSmem, st>>>(
              static_cast<const T*>(r), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const float*>(w),
              static_cast<const float*>(u), static_cast<const T*>(dy),
              static_cast<const float*>(states),
              static_cast<const float*>(dstates), static_cast<T*>(dr),
              static_cast<T*>(dk), static_cast<T*>(dv),
              static_cast<float*>(dw), static_cast<float*>(du_part),
              (passes & 2) ? nullptr : static_cast<float*>(ds_in), T_len,
              H, nt);
      if (int rc = static_cast<int>(cudaGetLastError())) return rc;
    }
    return 0;
  });
}

// out[0..11]: per pass (sums, scan, chunk) the registers, local bytes
// (spills and stack), shared memory and resident blocks per SM of its
// kernel for (dtype, K, V)
extern "C" int aqua_wkv6_keyslice_bwd_info(int dtype, int K, int V,
                                           int* out) {
  return by_type(dtype, K, V, [&](auto t, auto KC, auto VC) {
    using T = decltype(t);
    constexpr int KK = decltype(KC)::value, VV = decltype(VC)::value;
    if (int rc = prepare<T, KK, VV>()) return rc;
    if (int rc = ks::info(ks::sums_kernel<T, KK, VV, true>, 2 * VV, 0, out))
      return rc;
    if (int rc = ks::info(ks::scan_kernel<KK, VV>, ks::kScanThreads, 0,
                          out + 4))
      return rc;
    return ks::info(bwd_chunk_kernel<T, KK, VV>, 256,
                    ChunkCfg<T, KK, VV>::kSmem, out + 8);
  });
}
