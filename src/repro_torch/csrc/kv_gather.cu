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
// 2 * n * page_bytes over the card's memory rate. The design keeps the copy
// at that rate: a page payload is flat bytes (the reference's ``_canon``
// folding of any payload shape), each thread moves 16-byte vectors when the
// row size and both base pointers allow it, neighbouring threads touch
// neighbouring addresses, and one block copies a 16 KiB chunk of one page
// (grid = pages x chunks), so even a handful of pages spreads over many SMs.
// Page ids are bounds-checked in the kernel; an id outside the pool leaves
// its row untouched instead of reading or writing out of bounds.
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
  if (id < 0 || id >= n_pool) return;
  V* pool_row = pool + id * row_vecs;
  V* stage_row = staging + i * row_vecs;
  const long long base =
      static_cast<long long>(blockIdx.y) * kThreads * kVecPerThread;
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

}  // namespace

extern "C" int aqua_gather_pages(const void* pool, const int* ids, void* out,
                                 long long n, long long row_bytes,
                                 long long n_pool, void* stream) {
  return dispatch<true>(const_cast<void*>(pool), out, ids, n, row_bytes,
                        n_pool, stream);
}

extern "C" int aqua_scatter_pages(void* pool, const void* staging,
                                  const int* ids, long long n,
                                  long long row_bytes, long long n_pool,
                                  void* stream) {
  return dispatch<false>(pool, const_cast<void*>(staging), ids, n, row_bytes,
                         n_pool, stream);
}
