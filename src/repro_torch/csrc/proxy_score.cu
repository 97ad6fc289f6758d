// Fused Phase-1 identification: p = x @ W_r (f32 accumulation), p rounded to
// the storage dtype, score = cosine(p_rounded, p_cached) with the norm
// product floored at eps.
//
// Replaces: src/repro/kernels/proxy_score.py:proxy_score (Pallas,
//   _proxy_score_kernel), a grid over (batch, row block) with the d-long
//   projection of each block done in VMEM.
// Bound on the H100: bytes.  At the slice shape (B=4, N=512, d=4096, r=128,
//   bf16) the projection is 2.1 GFLOP but x alone is 16.8 MB, so the least
//   time is the ~19 MB read once (x, W_r, p_cached) and written once (p_now,
//   scores): about 6 us at 3.35 TB/s, against about 2 us of tensor-core work.
// Design: one block per (row tile, batch row); the whole d-loop runs inside
//   the block (nothing carries between blocks).  bf16: 32-row tiles, x and
//   W_r chunks of 64 staged in shared memory by a two-stage cp.async
//   pipeline (16-byte copies, the next chunk in flight while warp-level
//   tensor-core MMAs (wmma, f32 accumulators) consume this one).  f32: 16-row
//   tiles and a plain FMA loop (exact f32, no TF32).  The epilogue rounds p
//   through the storage dtype, writes p_now and reduces the three dot
//   products of each row with one warp per row, so p never makes an HBM
//   round trip before it is scored.  Every block re-reads W_r (1 MB at the
//   slice shape) from L2, 64 MB in all; sharing it across a cluster with
//   TMA multicast is later work.
//
// proxy_score_paged (replaces src/repro/kernels/proxy_score.py:
//   proxy_score_paged) reads p_cached through a page table from a pooled
//   arena [P, page, r] instead of a dense [B, N, r] buffer.  It is the same
//   kernel body, templated only on how a row of p_cached is addressed
//   (DenseRows / PagedRows), so its results are bitwise those of proxy_score
//   on the gathered pages.  Its bound is proxy_score's.
//
// Wide ranks (r > 256: the value / query / key identifiers project onto
//   kv_dim or q_dim, 4096 for LLaDA-8B).  A block cannot hold a 256 < r row
//   of p, so the projection runs alone (spa_proxy_project: the same
//   tensor-core body with the scoring epilogue swapped for a store, tiled
//   over (row tile, batch row, 256-column tile of r)) and writes the ROUNDED
//   p_now; cosine_drift (or cosine_drift_paged) then scores it.  That is the
//   JAX semantics exactly (the cosine of the rounded p), and the paged
//   result stays bitwise the dense one.  Bound at B=4, N=512, d=r=4096,
//   bf16: operations, 68.7 GFLOP = 0.069 ms at 989 TFLOP/s (the bytes, 84
//   MB, take 0.025 ms).  Every 256-column tile re-reads x from L2.
//
// cosine_drift (replaces src/repro/kernels/proxy_score.py:cosine_drift):
//   rowwise cosine(x, p_cached) with no projection, the norm product
//   floored at eps, f32 sums.  x and p_cached may differ in dtype (the
//   incremental identifier scores an f32 x against a bf16 cache).  One warp
//   per row reads both rows once with 16-byte loads, so the kernel is
//   bound by bytes: at attn_in width (B=4, N=512, r=4096, bf16 both) 33.6 MB,
//   0.010 ms at 3.35 TB/s; at the incremental width (r=128, f32 x) 1.6 MB,
//   0.5 us, where the launch dominates.
// cosine_drift_paged (replaces src/repro/kernels/proxy_score.py:
//   cosine_drift_paged) is that kernel with PagedRows: bitwise cosine_drift
//   on the gathered pages.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRMax = 256;      // largest rank a block holds

// Where row `row` of batch row b of p_cached lies.
template <typename T>
struct DenseRows {  // [B, N, r]
  const T* pc;
  int N, r;
  __device__ __forceinline__ const T* operator()(int b, int row) const {
    return pc + ((size_t)b * N + row) * r;
  }
};

template <typename T>
struct PagedRows {  // arena [P, page, r] through pt [B, n_log]
  const T* arena;
  const int* pt;
  int n_log, page, r;
  __device__ __forceinline__ const T* operator()(int b, int row) const {
    const int pid = pt[b * n_log + row / page];
    return arena + ((size_t)pid * page + row % page) * r;
  }
};

// ---- bf16: tensor-core tiles, two-stage cp.async pipeline ------------------
constexpr int kRowsB = 32;      // rows of x per block (2 MMA row tiles)
constexpr int kTkB = 64;        // d-chunk per pipeline stage
constexpr int kLdX = kTkB + 8;  // padded row stride of an x stage (bf16)
constexpr int kSlots = 4;       // accumulator tiles per warp (r <= 256)

size_t bf16_smem_bytes(int r) {
  const size_t stages = 2 * sizeof(__nv_bfloat16) *
                        (size_t)(kRowsB * kLdX + kTkB * (r + 8));
  const size_t p_tile = sizeof(float) * (size_t)kRowsB * (r + 8);
  return stages > p_tile ? stages : p_tile;
}

// Needs d % 8 == 0, r % 16 == 0 and 16-byte aligned x / w (checked by the
// wrapper): every tile row moves as 16-byte cp.async chunks.  kScore: the
// block holds all r <= 256 columns of p and scores them; otherwise it
// projects the 256-column tile blockIdx.z of a wide r and stores it.
template <typename Rows, bool kScore>
__global__ void __launch_bounds__(kThreads) proxy_score_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    Rows pc_row, float* __restrict__ scores,
    __nv_bfloat16* __restrict__ pnow, int N, int d, int r, float eps) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.z * kRMax;        // first column of p in the block
  const int nc = min(kRMax, r - c0);        // columns of p in the block
  const int ldw = nc + 8;
  bf16* xs0 = reinterpret_cast<bf16*>(smem);
  bf16* ws0 = xs0 + 2 * kRowsB * kLdX;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRowsB;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_tiles = (kRowsB / 16) * (nc / 16);
  const int r8 = nc / 8;
  const int n_k = (d + kTkB - 1) / kTkB;
  const bf16* xb = x + (size_t)b * N * d;

  auto load_stage = [&](int s, int k0) {
    bf16* xs = xs0 + s * kRowsB * kLdX;
    bf16* ws = ws0 + s * kTkB * ldw;
    for (int e = tid; e < kRowsB * (kTkB / 8); e += kThreads) {
      const int i = e / (kTkB / 8), c = (e % (kTkB / 8)) * 8;
      const int row = row0 + i, col = k0 + c;
      const bool ok = row < N && col < d;
      spa::cp_async16(xs + i * kLdX + c, ok ? xb + (size_t)row * d + col : x,
                      ok);
    }
    for (int e = tid; e < kTkB * r8; e += kThreads) {
      const int kk = e / r8, c = (e - kk * r8) * 8;
      const int col = k0 + kk;
      const bool ok = col < d;
      spa::cp_async16(ws + kk * ldw + c,
                      ok ? w + (size_t)col * r + c0 + c : w, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) wmma::fill_fragment(acc[t], 0.f);

  load_stage(0, 0);
  spa::cp_async_commit();
  for (int it = 0; it < n_k; ++it) {
    if (it + 1 < n_k) load_stage((it + 1) & 1, (it + 1) * kTkB);
    spa::cp_async_commit();
    spa::cp_async_wait<1>();  // this stage has landed; the next may fly
    __syncthreads();
    const bf16* xs = xs0 + (it & 1) * kRowsB * kLdX;
    const bf16* ws = ws0 + (it & 1) * kTkB * ldw;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int t = warp + slot * (kThreads / 32);
      if (t >= n_tiles) continue;
      const int rt = t % (kRowsB / 16), ct = t / (kRowsB / 16);
#pragma unroll
      for (int kk = 0; kk < kTkB; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, xs + rt * 16 * kLdX + kk, kLdX);
        wmma::load_matrix_sync(fb, ws + kk * ldw + ct * 16, ldw);
        wmma::mma_sync(acc[slot], fa, fb, acc[slot]);
      }
    }
    __syncthreads();  // the stage is free for the load two steps ahead
  }
  spa::cp_async_wait<0>();

  float* ps = reinterpret_cast<float*>(smem);  // [kRowsB][nc + 8]
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    const int t = warp + slot * (kThreads / 32);
    if (t >= n_tiles) continue;
    const int rt = t % (kRowsB / 16), ct = t / (kRowsB / 16);
    wmma::store_matrix_sync(ps + rt * 16 * ldw + ct * 16, acc[slot], ldw,
                            wmma::mem_row_major);
  }
  __syncthreads();

  if constexpr (!kScore) {  // wide r: store this column tile of p, rounded
    for (int e = tid; e < kRowsB * nc; e += kThreads) {
      const int i = e / nc, c = e - i * nc;
      const int row = row0 + i;
      if (row < N)
        pnow[((size_t)b * N + row) * r + c0 + c] =
            __float2bfloat16_rn(ps[i * ldw + c]);
    }
  } else {
    // epilogue: round p to bf16, write p_now, score against p_cached
    for (int i = warp; i < kRowsB; i += kThreads / 32) {
      const int row = row0 + i;
      if (row >= N) continue;
      const size_t off = ((size_t)b * N + row) * r;
      const bf16* pc = pc_row(b, row);
      float num = 0.f, pp = 0.f, cc = 0.f;
      for (int c = lane; c < r; c += 32) {
        const bf16 pr = __float2bfloat16_rn(ps[i * ldw + c]);
        pnow[off + c] = pr;
        const float p = __bfloat162float(pr);
        const float q = __bfloat162float(pc[c]);
        num += p * q;
        pp += p * p;
        cc += q * q;
      }
      num = spa::warp_sum(num);
      pp = spa::warp_sum(pp);
      cc = spa::warp_sum(cc);
      if (lane == 0)
        scores[(size_t)b * N + row] = num / fmaxf(sqrtf(pp * cc), eps);
    }
  }
}

// ---- f32: exact FMA loop ----------------------------------------------------
constexpr int kRows = 16;       // rows of x per block
constexpr int kTkF = 32;

template <typename Rows, bool kScore>
__global__ void __launch_bounds__(kThreads) proxy_score_f32(
    const float* __restrict__ x, const float* __restrict__ w,
    Rows pc_row, float* __restrict__ scores,
    float* __restrict__ pnow, int N, int d, int r, float eps) {
  __shared__ float xs[kRows][kTkF + 1];
  __shared__ float ws[kTkF * kRMax];  // reused as the p tile [kRows][kRMax]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kRMax;        // as in proxy_score_bf16
  const int nc = min(kRMax, r - c0);
  const int tid = threadIdx.x;
  const int trow = tid / 16, tcol = tid % 16;  // 16 rows x 16 column lanes
  const int nj = (nc + 15) / 16;
  const float* xb = x + (size_t)b * N * d;

  float acc[kRMax / 16];
#pragma unroll
  for (int j = 0; j < kRMax / 16; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTkF) {
    for (int e = tid; e < kRows * kTkF; e += kThreads) {
      const int i = e / kTkF, kk = e % kTkF;
      const int row = row0 + i, col = k0 + kk;
      xs[i][kk] = (row < N && col < d) ? xb[(size_t)row * d + col] : 0.f;
    }
    for (int e = tid; e < kTkF * nc; e += kThreads) {
      const int kk = e / nc, c = e % nc;
      const int col = k0 + kk;
      ws[kk * kRMax + c] = col < d ? w[(size_t)col * r + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kTkF; ++kk) {
      const float xv = xs[trow][kk];
#pragma unroll
      for (int j = 0; j < kRMax / 16; ++j) {
        const int c = tcol + 16 * j;
        if (j < nj && c < nc) acc[j] = fmaf(xv, ws[kk * kRMax + c], acc[j]);
      }
    }
    __syncthreads();
  }
  if constexpr (!kScore) {  // wide r: store this column tile of p
    const int row = row0 + trow;
    if (row < N) {
#pragma unroll
      for (int j = 0; j < kRMax / 16; ++j) {
        const int c = tcol + 16 * j;
        if (j < nj && c < nc) pnow[((size_t)b * N + row) * r + c0 + c] = acc[j];
      }
    }
  } else {
    float* ps = ws;
#pragma unroll
    for (int j = 0; j < kRMax / 16; ++j) {
      const int c = tcol + 16 * j;
      if (j < nj && c < nc) ps[trow * kRMax + c] = acc[j];
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int i = warp; i < kRows; i += kThreads / 32) {
      const int row = row0 + i;
      if (row >= N) continue;
      const size_t off = ((size_t)b * N + row) * r;
      const float* pc = pc_row(b, row);
      float num = 0.f, pp = 0.f, cc = 0.f;
      for (int c = lane; c < r; c += 32) {
        const float p = ps[i * kRMax + c];
        const float q = pc[c];
        pnow[off + c] = p;
        num += p * q;
        pp += p * p;
        cc += q * q;
      }
      num = spa::warp_sum(num);
      pp = spa::warp_sum(pp);
      cc = spa::warp_sum(cc);
      if (lane == 0)
        scores[(size_t)b * N + row] = num / fmaxf(sqrtf(pp * cc), eps);
    }
  }
}

template <template <typename> class Rows, typename... A>
int launch(const void* x, const void* w, const void* pc, void* scores,
           void* pnow, int B, int N, int d, int r, int dtype, float eps,
           void* stream, A... where) {
  if (B <= 0 || N <= 0) return 0;
  if (r <= 0 || r > kRMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spa::kBF16) {
    if (r % 16 || d % 8) return (int)cudaErrorInvalidValue;
    using T = __nv_bfloat16;
    const size_t bytes = bf16_smem_bytes(r);
    const cudaError_t err = cudaFuncSetAttribute(
        proxy_score_bf16<Rows<T>, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kRowsB - 1) / kRowsB, B);
    proxy_score_bf16<Rows<T>, true><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        Rows<T>{static_cast<const T*>(pc), where...},
        static_cast<float*>(scores), static_cast<T*>(pnow), N, d, r, eps);
  } else if (dtype == spa::kF32) {
    const dim3 grid((N + kRows - 1) / kRows, B);
    proxy_score_f32<Rows<float>, true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        Rows<float>{static_cast<const float*>(pc), where...},
        static_cast<float*>(scores), static_cast<float*>(pnow), N, d, r,
        eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The projection alone for a wide r (> 256): p_now = x @ w rounded to x's
// dtype, one block per (row tile, batch row, 256-column tile).
int launch_project(const void* x, const void* w, void* pnow, int B, int N,
                   int d, int r, int dtype, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_col = (r + kRMax - 1) / kRMax;
  if (dtype == spa::kBF16) {
    if (r % 16 || d % 8) return (int)cudaErrorInvalidValue;
    using T = __nv_bfloat16;
    const size_t bytes = bf16_smem_bytes(r < kRMax ? r : kRMax);
    const cudaError_t err = cudaFuncSetAttribute(
        proxy_score_bf16<DenseRows<T>, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kRowsB - 1) / kRowsB, B, n_col);
    proxy_score_bf16<DenseRows<T>, false><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        DenseRows<T>{nullptr, N, r}, nullptr, static_cast<T*>(pnow), N, d,
        r, 0.f);
  } else if (dtype == spa::kF32) {
    const dim3 grid((N + kRows - 1) / kRows, B, n_col);
    proxy_score_f32<DenseRows<float>, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        DenseRows<float>{nullptr, N, r}, nullptr,
        static_cast<float*>(pnow), N, d, r, 0.f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- cosine_drift: one warp per row, 8 elements a lane per load ----------
constexpr int kDriftRows = 8;   // rows (warps) per block

// Eight consecutive elements as f32 (16-byte aligned: r % 8 == 0 and the
// row bases are checked by the wrapper).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// x [B*N, r] in TX; row n of batch row b of p_cached at pc_row(b, n).
template <typename TX, typename Rows>
__global__ void __launch_bounds__(kDriftRows * 32) cosine_drift_kernel(
    const TX* __restrict__ x, Rows pc_row, float* __restrict__ scores,
    long long BN, int N, int r, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g = (long long)blockIdx.x * kDriftRows + warp;
  if (g >= BN) return;
  const TX* xr = x + g * r;
  const auto* pr = pc_row((int)(g / N), (int)(g % N));
  float num = 0.f, pp = 0.f, cc = 0.f;
#pragma unroll 4
  for (int c = lane * 8; c < r; c += 32 * 8) {
    float a[8], q[8];
    load8(xr + c, a);
    load8(pr + c, q);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      num = fmaf(a[i], q[i], num);
      pp = fmaf(a[i], a[i], pp);
      cc = fmaf(q[i], q[i], cc);
    }
  }
  num = spa::warp_sum(num);
  pp = spa::warp_sum(pp);
  cc = spa::warp_sum(cc);
  if (lane == 0) scores[g] = num / fmaxf(sqrtf(pp * cc), eps);
}

template <typename TX, typename TC, template <typename> class Rows,
          typename... A>
void drift_go(const void* x, const void* pc, void* scores, long long bn,
              int N, int r, float eps, cudaStream_t s, A... where) {
  const dim3 grid((unsigned)((bn + kDriftRows - 1) / kDriftRows));
  cosine_drift_kernel<TX, Rows<TC>><<<grid, kDriftRows * 32, 0, s>>>(
      static_cast<const TX*>(x), Rows<TC>{static_cast<const TC*>(pc), where...},
      static_cast<float*>(scores), bn, N, r, eps);
}

template <template <typename> class Rows, typename... A>
int launch_drift(const void* x, const void* pc, void* scores, int B, int N,
                 int r, int x_dtype, int pc_dtype, float eps, void* stream,
                 A... where) {
  if (B <= 0 || N <= 0) return 0;
  if (r <= 0 || r % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bn = (long long)B * N;
  using bf16 = __nv_bfloat16;
  const bool xf = x_dtype == spa::kF32, xb = x_dtype == spa::kBF16;
  const bool cf = pc_dtype == spa::kF32, cb = pc_dtype == spa::kBF16;
  if (xf && cf) drift_go<float, float, Rows>(x, pc, scores, bn, N, r, eps, s, where...);
  else if (xf && cb) drift_go<float, bf16, Rows>(x, pc, scores, bn, N, r, eps, s, where...);
  else if (xb && cf) drift_go<bf16, float, Rows>(x, pc, scores, bn, N, r, eps, s, where...);
  else if (xb && cb) drift_go<bf16, bf16, Rows>(x, pc, scores, bn, N, r, eps, s, where...);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,N,d], w [d,r], pc [B,N,r] (one dtype); scores [B,N] f32; pnow [B,N,r].
extern "C" int spa_proxy_score(const void* x, const void* w, const void* pc,
                               void* scores, void* pnow, int B, int N, int d,
                               int r, int dtype, float eps, void* stream) {
  return launch<DenseRows>(x, w, pc, scores, pnow, B, N, d, r, dtype, eps,
                           stream, N, r);
}

// As spa_proxy_score, with p_cached read from arena [P, page, r] (contiguous,
// x's dtype) through pt [B, n_log] int32; N == n_log * page.
extern "C" int spa_proxy_score_paged(const void* x, const void* w,
                                     const void* arena, const void* pt,
                                     void* scores, void* pnow, int B, int N,
                                     int d, int r, int page, int n_log,
                                     int dtype, float eps, void* stream) {
  if (page <= 0 || n_log * page != N) return (int)cudaErrorInvalidValue;
  return launch<PagedRows>(x, w, arena, scores, pnow, B, N, d, r, dtype, eps,
                           stream, static_cast<const int*>(pt), n_log, page,
                           r);
}

// x [B,N,d], w [d,r] (one dtype, r > 256 or any r); pnow [B,N,r] = x @ w
// rounded to that dtype.
extern "C" int spa_proxy_project(const void* x, const void* w, void* pnow,
                                 int B, int N, int d, int r, int dtype,
                                 void* stream) {
  return launch_project(x, w, pnow, B, N, d, r, dtype, stream);
}

// x [B,N,r], pc [B,N,r] (each f32 or bf16, r % 8 == 0, 16-byte aligned);
// scores [B,N] f32.
extern "C" int spa_cosine_drift(const void* x, const void* pc, void* scores,
                                int B, int N, int r, int x_dtype,
                                int pc_dtype, float eps, void* stream) {
  return launch_drift<DenseRows>(x, pc, scores, B, N, r, x_dtype, pc_dtype,
                                 eps, stream, N, r);
}

// As spa_cosine_drift, with pc read from arena [P, page, r] (contiguous)
// through pt [B, n_log] int32; N == n_log * page.
extern "C" int spa_cosine_drift_paged(const void* x, const void* arena,
                                      const void* pt, void* scores, int B,
                                      int N, int r, int page, int n_log,
                                      int x_dtype, int pc_dtype, float eps,
                                      void* stream) {
  if (page <= 0 || n_log * page != N) return (int)cudaErrorInvalidValue;
  return launch_drift<PagedRows>(x, arena, scores, B, N, r, x_dtype,
                                 pc_dtype, eps, stream,
                                 static_cast<const int*>(pt), n_log, page,
                                 r);
}
