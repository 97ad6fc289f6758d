// Shared helpers of the port's CUDA kernels (built for sm_90a by
// repro_torch/kernels/_lib.py into one library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spa {

// Element type codes passed from Python (kernels/_lib.py:dtype_code; f16
// only for the int8 cache's dequant scales).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch's and XLA's f32 -> bf16 casts
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// The current device's SM count, read once (host code).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy nbytes from src to dst with all threads of the block: 16-byte moves
// (four in flight per thread) where both ends and the length are 16-byte
// aligned, 4-byte or single-byte moves otherwise.  The two ranges must not
// overlap.
__device__ __forceinline__ void block_copy(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           long long nbytes) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) |
                          reinterpret_cast<uintptr_t>(src) |
                          static_cast<uintptr_t>(nbytes);
  const long long t = threadIdx.x, n = blockDim.x;
  if ((align & 15) == 0) {
    constexpr int kUnroll = 4;
    for (long long o = t * 16; o < nbytes; o += kUnroll * n * 16) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long oo = o + u * n * 16;
        if (oo < nbytes) v[u] = *reinterpret_cast<const uint4*>(src + oo);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long oo = o + u * n * 16;
        if (oo < nbytes) *reinterpret_cast<uint4*>(dst + oo) = v[u];
      }
    }
  } else if ((align & 3) == 0) {
    for (long long o = t * 4; o < nbytes; o += n * 4)
      *reinterpret_cast<uint32_t*>(dst + o) =
          *reinterpret_cast<const uint32_t*>(src + o);
  } else {
    for (long long o = t; o < nbytes; o += n) dst[o] = src[o];
  }
}

// 16-byte global -> shared copy that bypasses registers (sm_80+); with
// pred false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace spa
