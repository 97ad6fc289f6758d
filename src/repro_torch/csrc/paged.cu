// Paged cache copies (the paged serving pool): cache rows live in pooled
// arenas of fixed-size pages, and a per-request page table maps logical
// canvas page j of batch row b to physical page pt[b, j].  Physical page 0 is
// the pool's zero page: it is never written, and every logical page past a
// row's kv_len maps to it.
//
//   gather_pages       arena [L, P, page, F] -> dense view [L, B, n_log*page, F]
//   scatter_pages      the inverse, in place; writes to page 0 are dropped
//   scatter_rows_paged row commits [B, k, F] at logical rows idx [B, k] into
//                      ONE layer's arena [P, page, F], in place; rows with
//                      idx < 0, idx / page >= n_log or page id 0 are dropped
//
// Replaces: src/repro/kernels/scatter_update.py:gather_pages, scatter_pages
//   and scatter_rows_paged (Pallas), which prefetch the page table into SMEM
//   and move one contiguous DMA per page (gather/scatter) or per run of
//   consecutive rows (row commits).
// Bound on the H100: bytes.  At the serving slice (LLaDA-8B, B=4, N=512,
//   page 16, bf16) one gather or scatter of one buffer (K, V or H, F=4096)
//   reads 537 MB and writes 537 MB: 0.32 ms at 3.35 TB/s.  A proxy row commit
//   (k=128, r=128) moves 0.26 MB, well under a microsecond.
// Design: a page is one contiguous run of page * F elements on both sides,
//   so one block per (logical page, batch row, layer) moves it with
//   spa::block_copy (16-byte moves, four in flight per thread); the block
//   reads its own page id.  Row commits take one block per (selected row,
//   batch row) and resolve the row through the page table in the block.
//   Both are dtype-agnostic: they move bytes.
#include "common.cuh"

namespace {

constexpr int kPageThreads = 256;
constexpr int kRowThreads = 32;

template <bool kToArena>
__global__ void __launch_bounds__(kPageThreads) page_copy_kernel(
    char* arena, char* dense, const int* __restrict__ pt, int P, int B,
    int n_log, long long page_bytes) {
  const int j = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const int pid = pt[b * n_log + j];
  if (kToArena && pid <= 0) return;  // the zero page is never written
  char* a = arena + ((long long)l * P + pid) * page_bytes;
  char* d = dense + (((long long)l * B + b) * n_log + j) * page_bytes;
  if (kToArena)
    spa::block_copy(a, d, page_bytes);
  else
    spa::block_copy(d, a, page_bytes);
}

__global__ void __launch_bounds__(kRowThreads) rows_paged_kernel(
    char* arena, const int* __restrict__ pt, const int* __restrict__ idx,
    const char* rows, int k, int n_log, int page, long long row_bytes,
    long long page_stride, long long row_stride) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int i = idx[(long long)b * k + j];
  if (i < 0) return;
  const int lpage = i / page;
  if (lpage >= n_log) return;
  const int pid = pt[b * n_log + lpage];
  if (pid <= 0) return;
  spa::block_copy(arena + pid * page_stride + (i % page) * row_stride,
                  rows + ((long long)b * k + j) * row_bytes, row_bytes);
}

int launch_pages(bool to_arena, void* arena, const void* pt, void* dense,
                 int L, int P, int B, int n_log, long long page_bytes,
                 void* stream) {
  if (L <= 0 || B <= 0 || n_log <= 0 || page_bytes <= 0) return 0;
  const dim3 grid(n_log, B, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* a = static_cast<char*>(arena);
  char* d = static_cast<char*>(dense);
  const int* p = static_cast<const int*>(pt);
  if (to_arena)
    page_copy_kernel<true><<<grid, kPageThreads, 0, s>>>(a, d, p, P, B,
                                                         n_log, page_bytes);
  else
    page_copy_kernel<false><<<grid, kPageThreads, 0, s>>>(a, d, p, P, B,
                                                          n_log, page_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// arena [L, P, page, F] and dense [L, B, n_log * page, F], contiguous, one
// page = page_bytes; pt [B, n_log] int32.
extern "C" int spa_gather_pages(const void* arena, const void* pt,
                                void* dense, int L, int P, int B, int n_log,
                                long long page_bytes, void* stream) {
  return launch_pages(false, const_cast<void*>(arena), pt, dense, L, P, B,
                      n_log, page_bytes, stream);
}

extern "C" int spa_scatter_pages(void* arena, const void* pt,
                                 const void* dense, int L, int P, int B,
                                 int n_log, long long page_bytes,
                                 void* stream) {
  return launch_pages(true, arena, pt, const_cast<void*>(dense), L, P, B,
                      n_log, page_bytes, stream);
}

// arena: one layer's [P, page, F] (page and row strides in bytes; a row is
// row_bytes contiguous); pt [B, n_log], idx [B, k] int32; rows [B, k, F]
// contiguous.
extern "C" int spa_scatter_rows_paged(void* arena, const void* pt,
                                      const void* idx, const void* rows,
                                      int B, int k, int n_log, int page,
                                      long long row_bytes,
                                      long long page_stride,
                                      long long row_stride, void* stream) {
  if (B <= 0 || k <= 0 || row_bytes <= 0) return 0;
  if (page <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(k, B);
  rows_paged_kernel<<<grid, kRowThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(arena), static_cast<const int*>(pt),
      static_cast<const int*>(idx), static_cast<const char*>(rows), k, n_log,
      page, row_bytes, page_stride, row_stride);
  return (int)cudaGetLastError();
}
