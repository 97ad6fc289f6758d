// In-place multi-buffer row commit: the rows [B, k, ...] of every buffer of
// one commit (K + V (+ scales), or H (+ scale) + proxy) are written at
// idx [B, k] into their [B, N, ...] cache buffers in one launch; indices
// outside [0, N) are dropped; any index order is correct.
//
// Replaces: src/repro/kernels/scatter_update.py:scatter_update_multi (Pallas,
//   _scatter_multi_kernel), which walks index chunks and turns runs of 8
//   consecutive indices into one DMA.  That batching is a TPU transfer detail;
//   this kernel reproduces its result, not its scheme.
// Bound on the H100: bytes.  A K+V commit of k=128 rows at B=4 (32 heads of
//   128, bf16) moves 8.4 MB (read the rows once, write them once): about 2.5 us
//   at 3.35 TB/s; H + proxy moves 4.3 MB.
// Design: buffers of any dtype and row width travel as a descriptor array
//   (pointers and byte strides) passed by value, so one launch serves them
//   all.  One block per (selected row, batch row) copies that row of every
//   buffer with spa::block_copy.  Rows are independent, so no ordering
//   between blocks is needed.
#include "common.cuh"

namespace {

constexpr int kMaxBufs = 8;
constexpr int kThreads = 128;

struct Buf {
  char* dst;
  const char* src;
  long long row_bytes, dst_bstride, dst_rstride, src_bstride, src_rstride;
};

struct Bufs {
  Buf buf[kMaxBufs];
  int n;
};

__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const int* __restrict__ idx, int k, int N, Bufs bufs) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int i = idx[(size_t)b * k + j];
  if (i < 0 || i >= N) return;
  for (int t = 0; t < bufs.n; ++t) {
    const Buf& bb = bufs.buf[t];
    spa::block_copy(
        bb.dst + b * bb.dst_bstride + (long long)i * bb.dst_rstride,
        bb.src + b * bb.src_bstride + (long long)j * bb.src_rstride,
        bb.row_bytes);
  }
}

}  // namespace

// idx [B,k] int32; for buffer t: dst[t] / src[t] base addresses, row_bytes[t],
// batch and row strides in bytes of the cache (dst_*) and the rows (src_*).
extern "C" int spa_scatter_update_multi(
    const void* idx, int B, int k, int N, int nbuf, const long long* dst,
    const long long* src, const long long* row_bytes,
    const long long* dst_bstride, const long long* dst_rstride,
    const long long* src_bstride, const long long* src_rstride,
    void* stream) {
  if (B <= 0 || k <= 0 || nbuf == 0) return 0;
  if (nbuf < 0 || nbuf > kMaxBufs) return (int)cudaErrorInvalidValue;
  Bufs bufs;
  bufs.n = nbuf;
  for (int t = 0; t < nbuf; ++t) {
    bufs.buf[t] = Buf{reinterpret_cast<char*>(dst[t]),
                      reinterpret_cast<const char*>(src[t]), row_bytes[t],
                      dst_bstride[t], dst_rstride[t], src_bstride[t],
                      src_rstride[t]};
  }
  const dim3 grid(k, B);
  scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), k, N, bufs);
  return (int)cudaGetLastError();
}
