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
//   (k=128, r=128) moves 0.26 MB: 0.08 us, far below any launch, so its time
//   is latency: the chain of dependent loads before the first store.
// Design of the page copies: a page is one contiguous run of page * F
//   elements on both sides, so one block per (logical page, batch row,
//   layer) moves it with spa::block_copy (16-byte moves, four in flight per
//   thread); the block reads its own page id.
// Row commits (redesigned).  What held the first kernel back: one
//   32-thread CTA per (selected row, batch row), 512 at the serving slice,
//   each waiting on its index, then on its page id, then copying a 256-byte
//   row with half its lanes: three dependent round trips and a CTA to
//   schedule per row.  Design: a grid of one wave (kRowCtasPerSm CTAs an SM
//   at most) whose warps walk items: a run of up to 32 selected rows of the
//   flattened [B*k] commit, no more than a warp's 32 x kRowSlots moves hold
//   (32 rows of 256 bytes) and no more than spread the call over every warp
//   of the grid (one row a warp at the serving slice's 512), or one part of
//   a row wider than that (an 8 KB row is one item).  The run's source
//   bytes are contiguous, so a lane first issues its loads of the indices
//   (one a lane, one coalesced load), of its batch row's page table where
//   the run lies in one batch row and the table has at most 32 pages (one
//   id a lane, one coalesced load: the serving slice has 32), and of all its
//   moves; only then does it resolve its row's page id (by a shuffle, else
//   by a second lane-parallel load) and the drop rules.  The stores take
//   each row's destination from its lane by a shuffle.  The chain before
//   the first store is one round trip where the table sits in the lanes,
//   two where it does not.  Moves are 16 bytes where the arena, the rows,
//   the width and the strides allow, else 4 or 1 (int8 rows, f16 scales).
//   In place (chip_smoke.py phase 7, an NVIDIA H100 80GB HBM3 at 700 W):
//   2.16 us a call at the serving slice (the first kernel 2.25), 8 KB rows
//   3.13 (3.56).  Runs of several rows a warp form only where a call has
//   more rows than the grid has warps (2112 on that card): at k=4096
//   (B=2, 256-byte rows, runs of 4) phase 3 reads 0.0076 ms, against
//   0.0107 with one row a warp and 0.0110 for the first kernel.  Both
//   kernels are dtype-agnostic: they move bytes.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kPageThreads = 256;
constexpr int kRowWarps = 4;      // warps a CTA of the row commit
constexpr int kRowSlots = 16;     // moves a lane has in flight
constexpr int kRowCtasPerSm = 4;  // the row commit's grid: one wave

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

// One warp per item: the rows [r0, r0 + nr) of the flattened [B*k] commit
// (a run of up to 32), bytes [p0, p0 + w) of each (the whole row, or a
// part of a row wider than a warp's moves).  The item's source bytes are
// contiguous; the lane's kRowSlots moves of W bytes are all loaded before
// the indices' page ids are resolved, and stored after.
template <typename W>
__global__ void __launch_bounds__(32 * kRowWarps) rows_paged_kernel(
    char* arena, const int* __restrict__ pt, const int* __restrict__ idx,
    const char* __restrict__ rows, int n_rows, int k, int n_log, int page,
    long long row_bytes, long long page_stride, long long row_stride, int R,
    int pb, int parts, int items) {
  constexpr int V = sizeof(W);
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * kRowWarps;
  for (int it = blockIdx.x * kRowWarps + (threadIdx.x >> 5); it < items;
       it += nwarps) {
    const int run = parts == 1 ? it : it / parts;
    const int part = it - run * parts;
    const int r0 = run * R;
    const int nr = min(R, n_rows - r0);
    const long long p0 = (long long)part * pb;
    const int w = (int)min((long long)pb, row_bytes - p0);
    const int span = nr * w;  // <= 32 * kRowSlots * V
    const int slots = (span + 32 * V - 1) / (32 * V);  // the warp's moves
    // the run's indices, one a lane, by one coalesced load; where the run
    // lies in one batch row whose table fits a warp, that row's page ids
    // too, one a lane, so no load waits on an index
    const int i = lane < nr ? idx[r0 + lane] : -1;
    const int b0 = r0 / k;
    const bool lanes_hold_table =
        n_log <= 32 && (nr == 1 || (r0 + nr - 1) / k == b0);
    const int pid_lane = lanes_hold_table && lane < n_log
                             ? pt[(long long)b0 * n_log + lane]
                             : 0;
    const char* src = rows + (long long)r0 * row_bytes + p0;
    W v[kRowSlots];
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
      if (s == slots) break;
      const int off = (lane + 32 * s) * V;
      if (off < span) v[s] = *reinterpret_cast<const W*>(src + off);
    }
    // each lane's row: its page id (from the lane that holds it, else by a
    // second lane-parallel load), then its destination, or null where the
    // row drops
    const bool kept = i >= 0 && i / page < n_log;
    int pid = __shfl_sync(0xffffffffu, pid_lane, kept ? (i / page) & 31 : 0);
    if (!lanes_hold_table && kept)
      pid = pt[(long long)((r0 + lane) / k) * n_log + i / page];
    char* dst = nullptr;
    if (kept && pid > 0)
      dst = arena + pid * page_stride + (long long)(i % page) * row_stride + p0;
    if (nr == 1) {  // one row (the serving slice's case): no row arithmetic
      char* d = reinterpret_cast<char*>(__shfl_sync(
          0xffffffffu, reinterpret_cast<unsigned long long>(dst), 0));
#pragma unroll
      for (int s = 0; s < kRowSlots; ++s) {
        if (s == slots) break;
        const int off = (lane + 32 * s) * V;
        if (off < span && d != nullptr)
          *reinterpret_cast<W*>(d + off) = v[s];
      }
      continue;
    }
    // move s of the lane lies in row j of the run, at byte col of its part
    int j = lane * V / w, col = lane * V - j * w;
    const int dj = 32 * V / w, dcol = 32 * V - dj * w;
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
      if (s == slots) break;
      char* d = reinterpret_cast<char*>(__shfl_sync(
          0xffffffffu, reinterpret_cast<unsigned long long>(dst), j & 31));
      if ((lane + 32 * s) * V < span && d != nullptr)
        *reinterpret_cast<W*>(d + col) = v[s];
      j += dj;
      col += dcol;
      if (col >= w) {
        col -= w;
        ++j;
      }
    }
  }
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
  const unsigned long long align =
      reinterpret_cast<uintptr_t>(arena) | reinterpret_cast<uintptr_t>(rows) |
      row_bytes | page_stride | row_stride;
  const int V = (align & 15) == 0 ? 16 : (align & 3) == 0 ? 4 : 1;
  const long long n_rows = (long long)B * k;
  // an item: up to 32 whole rows that fit a warp's moves, as few as keep
  // every warp of the one-wave grid busy, or one part of a wider row
  const int cap = 32 * kRowSlots * V;
  const long long warps = (long long)spa::sm_count() * kRowCtasPerSm *
                          kRowWarps;
  const int R = row_bytes <= cap
                    ? (int)std::min({32LL, cap / row_bytes,
                                     (n_rows + warps - 1) / warps})
                    : 1;
  const int pb = (int)std::min(row_bytes, (long long)cap);
  const int parts = (int)((row_bytes + pb - 1) / pb);
  const long long items = (n_rows + R - 1) / R * parts;
  if (n_rows + 32 > 0x7fffffffLL || items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min((items + kRowWarps - 1) / kRowWarps,
                                           warps / kRowWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* a = static_cast<char*>(arena);
  const int* p = static_cast<const int*>(pt);
  const int* ii = static_cast<const int*>(idx);
  const char* src = static_cast<const char*>(rows);
#define SPA_ROWS(W)                                                       \
  rows_paged_kernel<W><<<grid, 32 * kRowWarps, 0, s>>>(                   \
      a, p, ii, src, (int)n_rows, k, n_log, page, row_bytes, page_stride, \
      row_stride, R, pb, parts, (int)items)
  if (V == 16)
    SPA_ROWS(uint4);
  else if (V == 4)
    SPA_ROWS(uint32_t);
  else
    SPA_ROWS(uint8_t);
#undef SPA_ROWS
  return (int)cudaGetLastError();
}
