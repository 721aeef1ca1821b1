// AQUA coalescing page gather / scatter for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/kv_gather/kernel.py:
//   gather_pages  (_copy_kernel)    pool (P, page...) --ids--> staging (n, page...)
//   scatter_pages (_scatter_kernel) staging --ids--> pool, in place
// They move every byte of a context switch: a parked request's scattered
// pages are packed into ONE contiguous staging buffer so the tier leg is a
// single large message (the paper's Section 5 kernel).
//
// Bound: bytes. A page copy does no arithmetic; the least time is
// 2 * n * page_bytes over the card's memory rate. A page payload is flat
// bytes (the reference's ``_canon`` folding of any payload shape). Page ids
// are bounds-checked in the kernel, one contract on both devices (the
// plain versions in kernels/kv_gather/ref.py keep it too): the gather
// writes a zero row for an id outside [0, P), the scatter writes nothing
// for it. Duplicate ids are allowed.
//
// Gather design, routed by shape (the route is part of the work plan that
// kernels/kv_gather/ops.py computes and passes in; nothing is retried):
//  * bulk route, every row whose size and both base addresses are
//    multiples of 16 bytes (all the port's planes: 64 KiB kv pages, 640 KiB
//    wkv and 10 KiB shift pages): a persistent grid of one-warp blocks
//    (about two per SM) walks work items (page i, chunk c), a chunk being a
//    page or a 16 KiB slice of one. One thread per block drives Hopper's
//    bulk copy engine (TMA, one-dimensional, so no tensor map): it arms a
//    stage's mbarrier with the chunk's byte count, issues
//    cp.async.bulk global -> shared into a ring of S stages, and once the
//    barrier's phase flips issues cp.async.bulk shared -> global into the
//    staging row. A stage is loaded again only after the store that read it
//    has finished reading (cp.async.bulk.wait_group.read), so S - 1 loads
//    stay in flight while a store drains. Loads carry an evict-first L2
//    hint (a parked page is read once; the staging rows stay cacheable for
//    the leg's next copy). The warp reads the ids of its next 64 items
//    ahead, so no id load sits in front of a copy. No thread moves data,
//    and no block pays a tail of half-empty waves.
//  * vector route, every other row: the kernel scatter also uses, one
//    block per 1024 elements of a page, each thread moving 4-byte or 1-byte
//    elements as the row size and base addresses allow.
// Scatter keeps the vector kernel, 16-byte vectors when the row size and
// both base pointers allow it, one block per 16 KiB chunk of one page.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;

template <typename V, bool kGather>
__global__ void __launch_bounds__(kThreads)
page_copy_kernel(V* __restrict__ pool, V* __restrict__ staging,
                 const int* __restrict__ ids, long long row_vecs,
                 long long n_pool) {
  const long long i = blockIdx.x;
  const long long id = ids[i];
  V* stage_row = staging + i * row_vecs;
  const long long base =
      static_cast<long long>(blockIdx.y) * kThreads * kVecPerThread;
  if (id < 0 || id >= n_pool) {
    if (!kGather) return;                 // scatter: no write
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {  // gather: a zero row
      const long long j = base + k * kThreads + threadIdx.x;
      if (j < row_vecs) stage_row[j] = V{};
    }
    return;
  }
  V* pool_row = pool + id * row_vecs;
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const long long j = base + k * kThreads + threadIdx.x;
    if (j < row_vecs) {
      if (kGather) {
        stage_row[j] = pool_row[j];
      } else {
        pool_row[j] = stage_row[j];
      }
    }
  }
}

template <typename V, bool kGather>
int launch(void* pool, void* staging, const int* ids, long long n,
           long long row_bytes, long long n_pool, cudaStream_t stream) {
  const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
  const long long per_block = static_cast<long long>(kThreads) * kVecPerThread;
  dim3 grid(static_cast<unsigned>(n),
            static_cast<unsigned>((row_vecs + per_block - 1) / per_block));
  page_copy_kernel<V, kGather><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(pool), static_cast<V*>(staging), ids, row_vecs, n_pool);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGather>
int dispatch(void* pool, void* staging, const int* ids, long long n,
             long long row_bytes, long long n_pool, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) |
                      reinterpret_cast<uintptr_t>(staging);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return launch<uint4, kGather>(pool, staging, ids, n, row_bytes, n_pool, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return launch<uint32_t, kGather>(pool, staging, ids, n, row_bytes, n_pool,
                                     s);
  return launch<uint8_t, kGather>(pool, staging, ids, n, row_bytes, n_pool, s);
}

// ---- bulk-copy gather ----------------------------------------------------

constexpr int kBulkThreads = 32;   // one warp: lane 0 issues, all read ids
constexpr int kMaxStages = 8;
constexpr int kRouteVector = 0;
constexpr int kRouteBulk = 1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// completes the phase with no bytes (an id outside the pool: the warp
// writes the chunk's zeros itself, see gather_bulk_kernel)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// An L2 policy that evicts first: a parked page is read once.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// Items of block b are k = b + m * gridDim.x, m = 0, 1, ...; item k is
// chunk c = k % cpr of staging row i = k / cpr. Stage s of the ring holds
// the chunk of the block's item m with m % S == s.
__global__ void __launch_bounds__(kBulkThreads)
gather_bulk_kernel(const char* __restrict__ pool, char* __restrict__ staging,
                   const int* __restrict__ ids, long long n_items,
                   long long cpr, long long row_bytes, int chunk, int stages,
                   long long n_pool) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int lane = threadIdx.x;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  if (first >= n_items) return;
  const long long my_items = (n_items - 1 - first) / stride + 1;
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t bar0 = smem_u32(full);

  // the id of the block's item m (-1 past its last), read by the warp 32
  // items at a time: `cur` holds window `win`, `nxt` the one after; the
  // first two windows are read before the barriers are set up, so their
  // latency hides behind it
  auto id_of = [&](long long m) {
    return m < my_items ? ids[(first + m * stride) / cpr] : -1;
  };
  int cur = id_of(lane);
  int nxt = id_of(32 + lane);
  long long win = 0;
  uint32_t valid = 0;    // lane 0: stage s holds a chunk to store
  const uint64_t policy = evict_first_policy();
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // load item m into stage s (every lane calls: the id comes by shuffle)
  auto load = [&](long long m, int s) {
    if ((m >> 5) != win) {
      cur = nxt;
      ++win;
      nxt = id_of(((win + 1) << 5) + lane);
    }
    const long long id =
        __shfl_sync(0xffffffffu, cur, static_cast<int>(m & 31));
    if (lane != 0) return;
    const uint32_t bar = bar0 + 8 * s;
    if (id < 0 || id >= n_pool) {
      mbar_arrive(bar);
      valid &= ~(1u << s);
      return;
    }
    const long long k = first + m * stride;
    const long long off = (k % cpr) * chunk;
    const uint32_t bytes =
        static_cast<uint32_t>(min(static_cast<long long>(chunk),
                                  row_bytes - off));
    mbar_expect_tx(bar, bytes);
    bulk_load(ring0 + s * chunk, pool + id * row_bytes + off, bytes, bar,
              policy);
    valid |= 1u << s;
  };

  const long long prologue = min(static_cast<long long>(stages), my_items);
  for (long long m = 0; m < prologue; ++m) load(m, static_cast<int>(m));
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (long long j = 0; j < my_items; ++j) {
    // stage s holds item j's chunk unless its id lay outside the pool; the
    // warp then writes the chunk's zeros with 16-byte stores (the bulk
    // route's rows and chunks are multiples of 16 bytes on 16-byte bases)
    if (!(__shfl_sync(0xffffffffu, valid, 0) >> s & 1u)) {
      const long long k = first + j * stride;
      const long long i = k / cpr;
      const long long off = (k - i * cpr) * chunk;
      const long long n16 = min(static_cast<long long>(chunk),
                                row_bytes - off) / 16;
      uint4* dst = reinterpret_cast<uint4*>(staging + i * row_bytes + off);
      for (long long t = lane; t < n16; t += kBulkThreads) dst[t] = uint4{};
    }
    if (lane == 0) {
      mbar_wait(bar0 + 8 * s, phase);
      if (valid >> s & 1u) {
        const long long k = first + j * stride;
        const long long i = k / cpr;
        const long long off = (k - i * cpr) * chunk;
        const uint32_t bytes =
            static_cast<uint32_t>(min(static_cast<long long>(chunk),
                                      row_bytes - off));
        bulk_store(staging + i * row_bytes + off, ring0 + s * chunk, bytes);
      }
      // one group per item, empty for a skipped id, so that "all groups
      // but the newest" below always means "up to item j - 1"
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    // refill the stage of item j - 1 with item j - 1 + S, once its store
    // has read it (the store of item j may still be reading)
    const long long m = j - 1 + stages;
    if (j >= 1 && m < my_items) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(m, prev);
    }
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  // the stores must have landed (and read the ring) before the block ends
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int launch_bulk(const void* pool, void* staging, const int* ids, long long n,
                long long row_bytes, long long n_pool, int chunk, int stages,
                int blocks, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) |
                      reinterpret_cast<uintptr_t>(staging);
  if (row_bytes % 16 || a % 16 || chunk <= 0 || chunk % 16 ||
      stages < 2 || stages > kMaxStages || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cpr = (row_bytes + chunk - 1) / chunk;
  const size_t smem = static_cast<size_t>(chunk) * stages;
  if (smem > 48 * 1024) {
    if (int e = static_cast<int>(cudaFuncSetAttribute(
            gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem))))
      return e;
  }
  gather_bulk_kernel<<<blocks, kBulkThreads, smem, stream>>>(
      static_cast<const char*>(pool), static_cast<char*>(staging), ids,
      n * cpr, cpr, row_bytes, chunk, stages, n_pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 1 bulk copy, 0 vector kernel; chunk, stages and blocks are the
// bulk route's work plan (ignored by the vector route).
extern "C" int aqua_gather_pages(const void* pool, const int* ids, void* out,
                                 long long n, long long row_bytes,
                                 long long n_pool, int route, int chunk,
                                 int stages, int blocks, void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  if (route == kRouteBulk)
    return launch_bulk(pool, out, ids, n, row_bytes, n_pool, chunk, stages,
                       blocks, static_cast<cudaStream_t>(stream));
  if (route != kRouteVector) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(const_cast<void*>(pool), out, ids, n, row_bytes,
                        n_pool, stream);
}

// Registers, local bytes and dynamic shared memory of the bulk-copy gather
// at a plan's chunk and stages, and the card's opt-in shared memory limit
// per block.
extern "C" int aqua_gather_pages_info(int chunk, int stages, int* out) {
  cudaFuncAttributes a;
  if (int rc = static_cast<int>(cudaFuncGetAttributes(&a, gather_bulk_kernel)))
    return rc;
  int dev = 0, optin = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (int rc = static_cast<int>(cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return rc;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = chunk * stages;
  out[3] = optin;
  return 0;
}

extern "C" int aqua_scatter_pages(void* pool, const void* staging,
                                  const int* ids, long long n,
                                  long long row_bytes, long long n_pool,
                                  void* stream) {
  return dispatch<false>(pool, const_cast<void*>(staging), ids, n, row_bytes,
                         n_pool, stream);
}
