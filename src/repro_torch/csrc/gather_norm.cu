// Phase-1 epilogue: gather the k selected rows of h (indices clamped to
// [0, N)) and emit them raw and rms-normed, row * rsqrt(mean(row^2) + eps)
// * (1 + w), in one pass.
//
// Replaces: src/repro/kernels/proxy_score.py:gather_norm (Pallas,
//   _gather_norm_kernel), a grid over (batch, index block) with the row
//   indices in SMEM and one DMA per row.
// Bound on the H100: bytes.  At the slice shape (B=4, k=128, d=4096, bf16) it
//   reads 4 MB of rows and writes 8 MB: about 4 us at 3.35 TB/s; the
//   arithmetic (3 flops an element) is negligible.
// Design: one block per (selected row, batch row).  The block reads its row
//   once, writes the raw copy while it sums the squares in f32 (block
//   reduction through shared memory), then writes the normed row from the
//   copy still in L1/L2.  No state crosses blocks; loads are coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_norm_kernel(
    const T* __restrict__ h, const int* __restrict__ idx,
    const T* __restrict__ w, T* __restrict__ rows, T* __restrict__ normed,
    int N, int d, int k, float eps) {
  __shared__ float partial[kThreads / 32];
  const int j = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  int i = idx[(size_t)b * k + j];
  i = i < 0 ? 0 : (i >= N ? N - 1 : i);
  const T* src = h + ((size_t)b * N + i) * d;
  const size_t out = ((size_t)b * k + j) * d;

  float ss = 0.f;
  for (int c = tid; c < d; c += kThreads) {
    const T v = src[c];
    rows[out + c] = v;
    const float f = spa::to_f32(v);
    ss += f * f;
  }
  ss = spa::warp_sum(ss);
  if (tid % 32 == 0) partial[tid / 32] = ss;
  __syncthreads();
  if (tid < 32) {
    float t = tid < kThreads / 32 ? partial[tid] : 0.f;
    t = spa::warp_sum(t);
    if (tid == 0) partial[0] = t;
  }
  __syncthreads();
  const float var = partial[0] / static_cast<float>(d);
  const float inv = rsqrtf(var + eps);
  for (int c = tid; c < d; c += kThreads) {
    const float f = spa::to_f32(src[c]);
    normed[out + c] =
        spa::from_f32<T>((f * inv) * (1.f + spa::to_f32(w[c])));
  }
}

}  // namespace

// h [B,N,d], idx [B,k] int32, w [d]; rows, normed [B,k,d] (h's dtype).
extern "C" int spa_gather_norm(const void* h, const void* idx, const void* w,
                               void* rows, void* normed, int B, int N, int d,
                               int k, int dtype, float eps, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(k, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(idx);
  if (dtype == spa::kBF16) {
    using T = __nv_bfloat16;
    gather_norm_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(h), ii, static_cast<const T*>(w),
        static_cast<T*>(rows), static_cast<T*>(normed), N, d, k, eps);
  } else if (dtype == spa::kF32) {
    gather_norm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), ii, static_cast<const float*>(w),
        static_cast<float*>(rows), static_cast<float*>(normed), N, d, k, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
