// Phase-1 epilogue: gather the k selected rows of h (indices clamped to
// [0, N)) and emit them raw and rms-normed, row * rsqrt(mean(row^2) + eps)
// * (1 + w), in one pass.
//
// Replaces: src/repro/kernels/proxy_score.py:gather_norm (Pallas,
//   _gather_norm_kernel), a grid over (batch, index block) with the row
//   indices in SMEM and one DMA per row.
// Bound on the H100: bytes.  Read the rows once, write the raw and the
//   normed rows, read w once: at the slice shape (B=4, k=128, d=4096, bf16)
//   12.6 MB, 3.8 us at 3.35 TB/s; at the hybrid's (B=2, k=4096) 201 MB,
//   60 us.  The arithmetic (3 flops an element) is negligible.
// What held the first port back: one 256-thread block per selected row
//   read the row an element (2 bytes) a thread per step, summed it through
//   shared memory with two block barriers, then read the row again and w
//   element by element for the normed row; every store was 2 bytes.
// Design: a row belongs to a group of W warps (at least 1 for rows of up
//   to 4 KB, 2 to 8 KB, ...; more, up to 8, when the call has too few rows
//   for 16 warps an SM), which holds it in registers: thread t of the
//   group loads vectors t, t + 32W, ... of the row (16 bytes where the
//   row's width and addresses allow, else 4 or 2), all of them before it
//   uses any, so the row is read once, by one load per vector.  The sum
//   of squares is f32 in a fixed order: each thread over its vectors in
//   order (elements in order), then a butterfly of warp shuffles, then the
//   group's warps in index order (through shared memory, behind a named
//   barrier of the group), so two calls agree bit for bit.  The raw row is
//   stored from the registers; the normed row, rounded once from f32, in
//   the same vectors, with (1 + w) from a copy of w that each CTA loads
//   into shared memory once.  Persistent CTAs of one or more groups take
//   contiguous ranges of rows (their indices staged in shared memory by
//   one coalesced load); the groups of a CTA take its rows in turn, so
//   many rows are in flight on each SM.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // 8 warps a CTA
constexpr int kMaxRowBytes = 32768;  // MAX_ROW_BYTES of kernels/proxy_score.py
constexpr int kMaxRowsPerCta = 2048;

// A vector of V bytes as 32-bit words (V = 2: the low half of one word).
template <int V>
struct Vec {
  static constexpr int kWords = V >= 4 ? V / 4 : 1;
  uint32_t w[kWords];
};

template <int V>
__device__ __forceinline__ Vec<V> vload(const char* p) {
  Vec<V> r;
  if constexpr (V == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r.w[0] = q.x;
    r.w[1] = q.y;
    r.w[2] = q.z;
    r.w[3] = q.w;
  } else if constexpr (V == 4) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    r.w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(char* p, const Vec<V>& r) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  } else {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(r.w[0]);
  }
}

// element e of a vector of T, as f32 (exact)
template <typename T, int V>
__device__ __forceinline__ float elem(const Vec<V>& x, int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(x.w[e]);
  } else {
    const uint32_t w = x.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// T: element type; V: bytes of a vector; VPL: vectors a thread holds.
template <typename T, int V, int VPL>
__global__ void __launch_bounds__(kMaxThreads) gather_norm_rows(
    const T* __restrict__ h, const int* __restrict__ idx,
    const T* __restrict__ w, T* __restrict__ rows, T* __restrict__ normed,
    int N, int d, int k, long long n_rows, int rpc, int warps_per_row,
    float eps) {
  constexpr int kE = V / (int)sizeof(T);  // elements a vector
  extern __shared__ __align__(16) char smem[];
  const int row_bytes = d * (int)sizeof(T);
  const int nvec = row_bytes / V;
  char* sw = smem;  // w, [d]
  int* sidx = reinterpret_cast<int*>(smem + ((row_bytes + 15) & ~15));
  float* part = reinterpret_cast<float*>(sidx + ((rpc + 3) & ~3));  // [2][8]

  const long long r0 = (long long)blockIdx.x * rpc;
  const int nr = (int)min((long long)rpc, n_rows - r0);
  // w into shared memory: every load of a step issued before its stores,
  // so a small CTA does not wait on one load after another
  for (int c0 = threadIdx.x; c0 < nvec; c0 += VPL * blockDim.x) {
    Vec<V> t[VPL];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = c0 + q * blockDim.x;
      if (c < nvec) t[q] = vload<V>(reinterpret_cast<const char*>(w) + c * V);
    }
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = c0 + q * blockDim.x;
      if (c < nvec) vstore<V>(sw + c * V, t[q]);
    }
  }
  for (int t = threadIdx.x; t < nr; t += blockDim.x) {
    const int i = idx[r0 + t];
    sidx[t] = i < 0 ? 0 : (i >= N ? N - 1 : i);
  }
  __syncthreads();

  const int W = warps_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / W, wg = warp - g * W;
  const int groups = blockDim.x / (32 * W);
  const int gt = wg * 32 + lane;  // thread within the group
  const int gs = 32 * W;          // vectors a step of the group
  int it = 0;
  for (int t = g; t < nr; t += groups, ++it) {
    const long long r = r0 + t;
    const long long b = r / k;
    const char* src =
        reinterpret_cast<const char*>(h + ((size_t)b * N + sidx[t]) * d);
    Vec<V> x[VPL];
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = gt + q * gs;
      if (c < nvec) x[q] = vload<V>(src + (size_t)c * V);
    }
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      if (gt + q * gs < nvec) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float f = elem<T, V>(x[q], e);
          ss += f * f;
        }
      }
    }
    ss = spa::warp_sum(ss);
    if (W > 1) {
      float* p = part + (it & 1) * 8 + g * W;
      if (lane == 0) p[wg] = ss;
      bar_sync(1 + g, 32 * W);
      ss = 0.f;
      for (int i = 0; i < W; ++i) ss += p[i];
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    char* raw = reinterpret_cast<char*>(rows + r * d);
    char* out = reinterpret_cast<char*>(normed + r * d);
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = gt + q * gs;
      if (c < nvec) vstore<V>(raw + (size_t)c * V, x[q]);
    }
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int c = gt + q * gs;
      if (c < nvec) {
        const Vec<V> wv = vload<V>(sw + c * V);
        Vec<V> y;
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll
          for (int e = 0; e < kE; ++e)
            y.w[e] = __float_as_uint((elem<T, V>(x[q], e) * inv) *
                                     (1.f + elem<T, V>(wv, e)));
        } else if constexpr (kE == 1) {
          y.w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(
              (elem<T, V>(x[q], 0) * inv) * (1.f + elem<T, V>(wv, 0))));
        } else {
#pragma unroll
          for (int e = 0; e < kE; e += 2) {
            const __nv_bfloat162 two = __floats2bfloat162_rn(
                (elem<T, V>(x[q], e) * inv) * (1.f + elem<T, V>(wv, e)),
                (elem<T, V>(x[q], e + 1) * inv) *
                    (1.f + elem<T, V>(wv, e + 1)));
            y.w[e >> 1] = *reinterpret_cast<const uint32_t*>(&two);
          }
        }
        vstore<V>(out + (size_t)c * V, y);
      }
    }
  }
}

// Warps a row, a power of two: the fewest whose threads hold the row's
// nvec vectors at most vpl_max a thread, doubled (up to 8, while each warp
// keeps a full step of 32 vectors) until the call has about 16 warps an SM,
// so a small call spreads each row's loads, squares and stores over more
// warps; 0 where even 8 warps cannot hold the row.
int warps_per_row(int nvec, int vpl_max, long long n_rows, int n_sm) {
  int W = 1;
  while (W * 32 * vpl_max < nvec) W *= 2;
  if (W > kMaxThreads / 32) return 0;
  while (W < kMaxThreads / 32 && 2 * W * n_rows <= 16LL * n_sm &&
         2 * W * 32 <= nvec)
    W *= 2;
  return W;
}

template <typename T, int V, int VPL>
int launch(const void* h, const void* idx, const void* w, void* rows,
           void* normed, int B, int N, int d, int k, int W, float eps,
           cudaStream_t s) {
  auto kernel = gather_norm_rows<T, V, VPL>;
  const long long n_rows = (long long)B * k;
  const int n_sm = spa::sm_count();
  // groups a CTA: enough to spread small calls over the SMs, at most 8 warps
  const long long want = (n_rows + n_sm - 1) / n_sm;
  const int groups =
      (int)std::max(1LL, std::min(want, (long long)(kMaxThreads / 32 / W)));
  const int threads = 32 * W * groups;
  const int row_smem = (d * (int)sizeof(T) + 15) & ~15;
  const int smem_max = row_smem + 4 * kMaxRowsPerCta + 64;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem_max);
  if (e != cudaSuccess) return (int)e;
  long long grid = std::min((n_rows + groups - 1) / groups,
                            (long long)n_sm * std::max(per_sm, 1));
  grid = std::max(grid, (n_rows + kMaxRowsPerCta - 1) / kMaxRowsPerCta);
  const int rpc = (int)((n_rows + grid - 1) / grid);
  grid = (n_rows + rpc - 1) / rpc;
  const int smem = row_smem + 4 * ((rpc + 3) & ~3) + 64;
  kernel<<<(unsigned)grid, threads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const int*>(idx),
      static_cast<const T*>(w), static_cast<T*>(rows), static_cast<T*>(normed),
      N, d, k, n_rows, rpc, W, eps);
  return (int)cudaGetLastError();
}

// 16-byte vectors: the instance whose threads hold no more vectors than
// the row needs at its number of warps (2, 4 or 8 a thread).
template <typename T>
int launch16(const void* h, const void* idx, const void* w, void* rows,
             void* normed, int B, int N, int d, int k, float eps,
             cudaStream_t s) {
  const int nvec = d * (int)sizeof(T) / 16;
  const int W = warps_per_row(nvec, 8, (long long)B * k, spa::sm_count());
  if (W == 0) return (int)cudaErrorInvalidValue;
  const int need = (nvec + 32 * W - 1) / (32 * W);
  if (need <= 2)
    return launch<T, 16, 2>(h, idx, w, rows, normed, B, N, d, k, W, eps, s);
  if (need <= 4)
    return launch<T, 16, 4>(h, idx, w, rows, normed, B, N, d, k, W, eps, s);
  return launch<T, 16, 8>(h, idx, w, rows, normed, B, N, d, k, W, eps, s);
}

// narrower vectors (rows or addresses not 16-byte aligned): one instance
template <typename T, int V, int VPL>
int launch_narrow(const void* h, const void* idx, const void* w, void* rows,
                  void* normed, int B, int N, int d, int k, float eps,
                  cudaStream_t s) {
  const int W = warps_per_row(d * (int)sizeof(T) / V, VPL, (long long)B * k,
                              spa::sm_count());
  if (W == 0) return (int)cudaErrorInvalidValue;
  return launch<T, V, VPL>(h, idx, w, rows, normed, B, N, d, k, W, eps, s);
}

}  // namespace

// h [B,N,d], idx [B,k] int32, w [d]; rows, normed [B,k,d] (h's dtype);
// rows of at most kMaxRowBytes bytes.
extern "C" int spa_gather_norm(const void* h, const void* idx, const void* w,
                               void* rows, void* normed, int B, int N, int d,
                               int k, int dtype, float eps, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (N <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == spa::kBF16 ? 2 : 4;
  if (d * es > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  // the widest vector that the row width and every address allow (the
  // outputs are fresh allocations)
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(rows) |
                          reinterpret_cast<uintptr_t>(normed) |
                          static_cast<uintptr_t>(d * es);
  if (dtype == spa::kBF16) {
    using T = __nv_bfloat16;
    if ((align & 15) == 0)
      return launch16<T>(h, idx, w, rows, normed, B, N, d, k, eps, s);
    if ((align & 3) == 0)
      return launch_narrow<T, 4, 32>(h, idx, w, rows, normed, B, N, d, k,
                                     eps, s);
    return launch_narrow<T, 2, 64>(h, idx, w, rows, normed, B, N, d, k, eps,
                                   s);
  }
  if (dtype == spa::kF32) {
    if ((align & 15) == 0)
      return launch16<float>(h, idx, w, rows, normed, B, N, d, k, eps, s);
    return launch_narrow<float, 4, 32>(h, idx, w, rows, normed, B, N, d, k,
                                       eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
