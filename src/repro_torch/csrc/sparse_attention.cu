// Gathered-query attention against the KV cache, with the f32 online softmax
// of the JAX kernel's _attn_step: the dense grid (every kv block) and the
// banded grid (each q block visits only n_band kv blocks).  Also serves
// prefill (contiguous query positions).
//
// Replaces: src/repro/kernels/sparse_attention.py:sparse_attention, dense grid
//   (_dense_kernel -> _attn_step), a grid over (batch, head, q block, kv
//   block) whose sequential kv axis carries (m, l, acc) in VMEM scratch, and
//   its banded grid (_banded_kernel): JAX q block i (bq queries) visits kv
//   blocks starts[i] .. starts[i] + n_band - 1 (of bk keys) only, keys
//   outside that range dropped besides the masks.
// Semantics, term for term: s = (q . k) * scale, then soft_cap * tanh(s /
//   soft_cap) when soft_cap > 0; masked keys (kv_pos >= N or >= kv_len[b], or
//   |q_pos - kv_pos| > window when window > 0) score NEG_INF = -1e30 and get
//   p = 0; alpha = 0 while the running max is <= NEG_INF / 2; rows with l == 0
//   output 0; padded query rows sit at position 2^30.  GQA maps q head h to kv
//   head h / (H / KVH); int8 K/V are dequantized with per-row f32 scales.
// Bound on the H100: bytes.  At B=4, N=512, 32 heads of 128, bf16, the K/V
//   cache is 33.5 MB and kq=128 gathered queries need 4.3 GFLOP: about 10 us
//   to read K/V once against about 4 us of tensor-core work.  Prefill
//   (kq = N = 512) needs 17 GFLOP against 67 MB: 20 us of bytes, 17 us of
//   operations.
// Bound of the banded grid at RecurrentGemma-9B's decode (B=2, N=16384, 16
//   query heads on one kv head of 256, window 2048, kq = 4096 stratified
//   queries, n_band = 26 blocks of 512): operations.  K/V are 33.5 MB, but
//   every query needs the keys of its window, 2 * 2048 + 1 = 4097 (fewer
//   at the canvas edges), in 16 heads: 4 * B * kq * H * 4097 * hd = 0.55
//   TFLOP, 0.56 ms at the bf16 peak against 0.01 ms of bytes.  (The band of
//   26 blocks is 13312 keys a query, 3.25x what the function needs.)
//   Prefill (kq = N) is 2.2 TFLOP.
// Design: a block owns a tile of queries of one head and one batch row and
//   loops over kv tiles inside the block (the sequential grid axis of the
//   TPU becomes this loop), so no state crosses blocks.  The banded grid is
//   the same body with the loop bounded to [starts[i] * bk, (starts[i] +
//   n_band) * bk): a block's 64 (or 16) queries lie inside one JAX q block
//   (bq is 512, or kq when there is one q block).  Both grids also skip
//   the tiles past kv_len and, with a window, the tiles outside [least
//   query position - window, greatest + window] of the block's queries
//   (kv_range).  A skipped tile is fully masked, and a fully masked tile
//   leaves (m, l, acc) as they were, so the skip changes no bit and,
//   where the band covers the window, banded equals dense bit for bit.
//   Two variants:
//   - bf16 K/V with head_dim 32, 64, 128 or 256 (the main path): 64 queries
//     per block, one warp per 16; a 64-key K/V tile is staged once in shared
//     memory for the 4 warps; S and P V are warp-level tensor-core MMAs
//     (wmma, f32 accumulators); softmax state and the running output stay
//     f32; P enters P V as a bf16 hi/lo pair (two MMAs), so it keeps f32
//     accuracy to 2^-17, as in the f32 reference.
//   - f32 K/V, or int8 K/V with dequant scales (q in f32 or bf16), head_dim
//     up to 256: 16 queries per block, 32-key tiles dequantized to f32 in
//     shared memory, exact f32 FMAs on the CUDA cores.
//   bf16 K/V of another head_dim, with scales, or not 16-byte aligned are
//   refused (cudaErrorInvalidValue), never run on a slower path.  At
//   head_dim 256 a block takes about 205 KB of shared memory (one block an
//   SM) and holds 16 Q fragments a warp in registers.
//   K/V tiles are re-read by every query tile and every head of a GQA group
//   (from L2 at decode sizes); wgmma/TMA pipelines are later work.
#include <climits>
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 16;        // queries per block
constexpr int kBK = 32;        // keys per tile (one warp lane per key)
constexpr int kThreads = 128;  // 4 warps

// The keys [*lo, *hi) a tile of queries at positions [qmin, qmax] visits:
// its q block's band on the banded grid (band_start >= 0), else every key,
// cut to kv_limit and, with a window, to [qmin - window, qmax + window].
// Every tile outside that range is fully masked for all the tile's
// queries and would leave (m, l, acc) as they were, so skipping it changes
// no bit.  *lo is rounded down to a multiple of the tile, so the tiles
// visited are the dense grid's (band starts are multiples of bk, itself a
// multiple of the tile).
__device__ __forceinline__ void kv_range(int band_start, int n_band, int bk,
                                         int N, int kv_limit, int window,
                                         int qmin, int qmax, int tile,
                                         int* lo, int* hi) {
  long long l = 0, h = min(N, kv_limit);
  if (band_start >= 0) {
    l = (long long)band_start * bk;
    h = min(h, l + (long long)n_band * bk);
  }
  if (window > 0) {
    l = max(l, (long long)qmin - window);
    h = min(h, (long long)qmax + window + 1);
  }
  *lo = (int)(l / tile * tile);
  *hi = (int)max(h, 0LL);
}

template <typename T>
__device__ __forceinline__ float load_kv(const void* p, size_t i) {
  return spa::to_f32(static_cast<const T*>(p)[i]);
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const T* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, const int* __restrict__ qpos,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kvlen, T* __restrict__ out, int kq, int H, int N,
    int KVH, int hd, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][hd]
  float* kt = qs + kBQ * hd;               // [kBK][hd + 1]
  float* vt = kt + kBK * (hd + 1);         // [kBK][hd]
  float* sc = vt + kBK * hd;               // [kBQ][kBK] scores, then p
  float* acc = sc + kBQ * kBK;             // [kBQ][hd]
  float* m_s = acc + kBQ * hd;             // [kBQ]
  float* l_s = m_s + kBQ;                  // [kBQ]
  float* a_s = l_s + kBQ;                  // [kBQ]
  int* qp_s = reinterpret_cast<int*>(a_s + kBQ);  // [kBQ]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_limit = kvlen ? kvlen[b] : N;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, c = e % hd, qi = q0 + i;
    qs[e] = qi < kq ? spa::to_f32(q[(((size_t)b * kq + qi) * H + h) * hd + c])
                    : 0.f;
    acc[e] = 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = spa::kNegInf;
    l_s[tid] = 0.f;
    qp_s[tid] = q0 + tid < kq ? qpos[(size_t)b * kq + q0 + tid] : (1 << 30);
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < kBQ && q0 + i < kq; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }
  int kv_lo, kv_hi;
  kv_range(starts ? starts[q0 / bq] : -1, n_band, bk, N, kv_limit, window,
           qmin, qmax, kBK, &kv_lo, &kv_hi);
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kBK) {
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, c = e % hd, p = kv0 + j;
      float kf = 0.f, vf = 0.f;
      if (p < N) {
        const size_t row = ((size_t)b * N + p) * KVH + kvh;
        kf = load_kv<KV>(k, row * hd + c);
        vf = load_kv<KV>(v, row * hd + c);
        if (ks) {
          kf *= ks[row];
          vf *= vs[row];
        }
      }
      kt[j * (hd + 1) + c] = kf;
      vt[j * hd + c] = vf;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK, p = kv0 + j;
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(qs[i * hd + c], kt[j * (hd + 1) + c], s);
      s *= scale;
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      const bool valid = p < N && p < kv_limit &&
                         (window <= 0 || abs(qp_s[i] - p) <= window);
      sc[e] = valid ? s : spa::kNegInf;
    }
    __syncthreads();

    for (int i = warp; i < kBQ; i += kThreads / 32) {
      const int p = kv0 + lane;
      const bool valid = p < N && p < kv_limit &&
                         (window <= 0 || abs(qp_s[i] - p) <= window);
      const float s = sc[i * kBK + lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, spa::warp_max(s));
      const float pr = valid ? expf(s - m_new) : 0.f;
      const float alpha = m_prev <= spa::kNegInf / 2 ? 0.f : expf(m_prev - m_new);
      const float psum = spa::warp_sum(pr);
      sc[i * kBK + lane] = pr;
      if (lane == 0) {
        l_s[i] = alpha * l_s[i] + psum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < kBQ * hd; e += kThreads) {
      const int i = e / hd, c = e % hd;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) pv = fmaf(sc[i * kBK + j], vt[j * hd + c], pv);
      acc[e] = a_s[i] * acc[e] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, c = e % hd, qi = q0 + i;
    if (qi >= kq) continue;
    const float l = l_s[i];
    out[(((size_t)b * kq + qi) * H + h) * hd + c] =
        spa::from_f32<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

// ---- bf16 K/V: tensor-core tiles -------------------------------------------
// One block per (64-query tile, q head, batch row), one warp per 16 queries.
// A K/V tile of 64 keys is staged once in shared memory for the 4 warps.
// S = Q K^T and O = P V run as warp-level tensor-core MMAs (wmma, bf16 in,
// f32 accumulate; Q stays in registers as MMA fragments); the online
// softmax stays f32 per row.  The f32 P is split into P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and O = P_hi V + P_lo V: V is bf16 already, so
// the products are exact and P is off by at most 2^-17 of itself, where a
// single bf16 P would be off by 2^-9 while l sums the unrounded P.
// head_dim is a compile-time 32, 64, 128 or 256; 16-byte aligned q/k/v; no
// dequant scales.  About 110 KB of shared memory at head_dim 128 (two
// blocks per SM), 205 KB at 256 (one).
constexpr int kWarpsT = 4;
constexpr int kBQT = 16 * kWarpsT;  // queries per block
constexpr int kBKT = 64;            // keys per tile
constexpr int kThreadsT = 32 * kWarpsT;

template <int HD>
struct TcLayout {
  static constexpr int kLd = HD + 8;                       // Q/K/V rows, bf16
  static constexpr int kLdS = (HD > kBKT ? HD : kBKT) + 4;  // S / O rows, f32
  static constexpr int kLdP = kBKT + 8;                    // P rows, bf16
  static constexpr size_t kKv = (size_t)kBKT * kLd * 2;    // one K or V tile
  static constexpr size_t kWarp =
      ((size_t)16 * kLdS * 4 +   // S, then O (aliased); Q staging at start
       (size_t)16 * HD * 4 +     // running output
       (size_t)16 * kLdP * 2 +   // P_hi, then P_lo
       4 * 16 * 4 + 127) / 128 * 128;  // m, l, alpha, q_pos
  static constexpr size_t kBytes = 2 * kKv + kWarpsT * kWarp;
};

template <int HD>
__global__ void __launch_bounds__(kThreadsT) attention_bf16_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ out, int kq,
    int H, int N, int KVH, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  using L = TcLayout<HD>;
  constexpr int kHd8 = HD / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* kt = reinterpret_cast<bf16*>(tc_smem);
  bf16* vt = reinterpret_cast<bf16*>(tc_smem + L::kKv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned char* wbase = tc_smem + 2 * L::kKv + warp * L::kWarp;
  float* so = reinterpret_cast<float*>(wbase);
  float* acc = so + 16 * L::kLdS;
  bf16* pb = reinterpret_cast<bf16*>(acc + 16 * HD);
  float* m_s = reinterpret_cast<float*>(pb + 16 * L::kLdP);
  float* l_s = m_s + 16;
  float* a_s = l_s + 16;
  int* qp_s = reinterpret_cast<int*>(a_s + 16);

  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kBQT + warp * 16;  // this warp's first query
  const int kv_limit = kvlen ? kvlen[b] : N;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const bool active = q0 < kq;

  // Q -> registers, staged through the S/O scratch as bf16 rows
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
  {
    bf16* qs = reinterpret_cast<bf16*>(so);
    for (int e = lane; e < 16 * kHd8; e += 32) {
      const int i = e / kHd8, c = (e % kHd8) * 8, qi = q0 + i;
      *reinterpret_cast<uint4*>(qs + i * L::kLd + c) =
          qi < kq ? *reinterpret_cast<const uint4*>(
                        q + (((size_t)b * kq + qi) * H + h) * HD + c)
                  : zero;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], qs + kk * 16, L::kLd);
    __syncwarp();
  }
  for (int i = 0; i < 16; ++i)
    for (int c = lane; c < HD; c += 32) acc[i * HD + c] = 0.f;
  if (lane < 16) {
    m_s[lane] = spa::kNegInf;
    l_s[lane] = 0.f;
    qp_s[lane] = q0 + lane < kq ? qpos[(size_t)b * kq + q0 + lane] : (1 << 30);
  }

  __shared__ int q_rng[2];  // the block's least and greatest query position
  if (tid == 0) {
    q_rng[0] = INT_MAX;
    q_rng[1] = INT_MIN;
  }
  __syncthreads();
  if (lane < 16 && q0 + lane < kq) {
    atomicMin(&q_rng[0], qp_s[lane]);
    atomicMax(&q_rng[1], qp_s[lane]);
  }
  __syncthreads();
  int kv_lo, kv_hi;
  kv_range(starts ? starts[blockIdx.x * kBQT / bq] : -1, n_band, bk, N,
           kv_limit, window, q_rng[0], q_rng[1], kBKT, &kv_lo, &kv_hi);
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kBKT) {
    __syncthreads();  // every warp is done with the previous tile
    for (int e = tid; e < kBKT * kHd8; e += kThreadsT) {
      const int j = e / kHd8, c = (e % kHd8) * 8, p = kv0 + j;
      uint4 kk4 = zero, vv4 = zero;
      if (p < N) {
        const size_t off = (((size_t)b * N + p) * KVH + kvh) * HD + c;
        kk4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(kt + j * L::kLd + c) = kk4;
      *reinterpret_cast<uint4*>(vt + j * L::kLd + c) = vv4;
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T: four 16-key column tiles, f32 accumulators
#pragma unroll
    for (int jt = 0; jt < kBKT / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fs;
      wmma::fill_fragment(fs, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, kt + jt * 16 * L::kLd + kk * 16, L::kLd);
        wmma::mma_sync(fs, qf[kk], fb, fs);
      }
      wmma::store_matrix_sync(so + jt * 16, fs, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two keys per lane; the f32 P
    // overwrites S in place (each lane rewrites the entries it read)
    for (int i = 0; i < 16; ++i) {
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u, p = kv0 + j;
        float s = so[i * L::kLdS + j] * scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        ok[u] = p < N && p < kv_limit &&
                (window <= 0 || abs(qp_s[i] - p) <= window);
        sv[u] = ok[u] ? s : spa::kNegInf;
      }
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, spa::warp_max(fmaxf(sv[0], sv[1])));
      const float e0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
      const float e1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
      const float psum = spa::warp_sum(e0 + e1);
      so[i * L::kLdS + lane] = e0;
      so[i * L::kLdS + lane + 32] = e1;
      if (lane == 0) {
        const float alpha =
            m_prev <= spa::kNegInf / 2 ? 0.f : expf(m_prev - m_new);
        l_s[i] = alpha * l_s[i] + psum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncwarp();

    // P_hi and P_lo -> fragments (through the bf16 scratch, one at a time)
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
        ph[kBKT / 16], pl[kBKT / 16];
    for (int e = lane; e < 16 * kBKT; e += 32) {
      const int i = e / kBKT, j = e % kBKT;
      pb[i * L::kLdP + j] = __float2bfloat16_rn(so[i * L::kLdS + j]);
    }
    __syncwarp();
#pragma unroll
    for (int jt = 0; jt < kBKT / 16; ++jt)
      wmma::load_matrix_sync(ph[jt], pb + jt * 16, L::kLdP);
    __syncwarp();
    for (int e = lane; e < 16 * kBKT; e += 32) {
      const int i = e / kBKT, j = e % kBKT;
      const float pv = so[i * L::kLdS + j];
      pb[i * L::kLdP + j] = __float2bfloat16_rn(
          pv - __bfloat162float(__float2bfloat16_rn(pv)));
    }
    __syncwarp();
#pragma unroll
    for (int jt = 0; jt < kBKT / 16; ++jt)
      wmma::load_matrix_sync(pl[jt], pb + jt * 16, L::kLdP);
    __syncwarp();

    // O = P_hi V + P_lo V into the scratch, then acc = alpha * acc + O
#pragma unroll
    for (int ct = 0; ct < HD / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
      wmma::fill_fragment(fo, 0.f);
#pragma unroll
      for (int jt = 0; jt < kBKT / 16; ++jt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, vt + jt * 16 * L::kLd + ct * 16, L::kLd);
        wmma::mma_sync(fo, ph[jt], fb, fo);
        wmma::mma_sync(fo, pl[jt], fb, fo);
      }
      wmma::store_matrix_sync(so + ct * 16, fo, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const float alpha = a_s[i];
#pragma unroll
      for (int c = lane; c < HD; c += 32)
        acc[i * HD + c] = alpha * acc[i * HD + c] + so[i * L::kLdS + c];
    }
    __syncwarp();
  }
  if (!active) return;
  for (int i = 0; i < 16; ++i) {
    const int qi = q0 + i;
    if (qi >= kq) break;
    const float l = l_s[i];
    const float inv_l = 1.f / (l == 0.f ? 1.f : l);
    bf16* o = out + (((size_t)b * kq + qi) * H + h) * HD;
    for (int c = lane; c < HD; c += 32)
      o[c] = __float2bfloat16_rn(acc[i * HD + c] * inv_l);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const int* qpos,
              const int* kvlen, void* out, int B, int kq, int H, int N,
              int KVH, int window, float scale, float soft_cap,
              const int* starts, int n_band, int bq, int bk, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const size_t bytes = TcLayout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((kq + kBQT - 1) / kBQT, H, B);
  attention_bf16_tc<HD><<<grid, kThreadsT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qpos, kvlen, static_cast<bf16*>(out), kq,
      H, N, KVH, window, scale, soft_cap, starts, n_band, bq, bk);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(kBQ * hd + kBK * (hd + 1) + kBK * hd +
                                  kBQ * kBK + kBQ * hd + 4 * kBQ);
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const float* ks, const float* vs, const int* kvlen, void* out,
           int B, int kq, int H, int N, int KVH, int hd, int window,
           float scale, float soft_cap, const int* starts, int n_band, int bq,
           int bk, cudaStream_t s) {
  const size_t bytes = smem_bytes(hd);
  auto kern = attention_kernel<T, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((kq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), k, v, qpos, ks, vs, kvlen,
      static_cast<T*>(out), kq, H, N, KVH, hd, window, scale, soft_cap,
      starts, n_band, bq, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,kq,H,hd]; k/v [B,N,KVH,hd] (q's dtype, or int8 with ks/vs [B,N,KVH]
// f32 scales; ks == vs == nullptr means unit scales); qpos [B,kq] int32;
// kvlen [B] int32 or nullptr (= N); out [B,kq,H,hd] in q's dtype.
// starts == nullptr: the dense grid.  Else the banded grid: starts
// [ceil(kq / bq)] int32 kv-block indices (of bk keys), n_band blocks each;
// bq must be a multiple of 64 or at least kq, bk a multiple of 64.
extern "C" int spa_sparse_attention(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* ks, const void* vs,
                                    const void* kvlen, void* out, int B,
                                    int kq, int H, int N, int KVH, int hd,
                                    int dtype, int quant, int window,
                                    float scale, float soft_cap,
                                    const void* starts, int n_band, int bq,
                                    int bk, void* stream) {
  if (B <= 0 || kq <= 0) return 0;
  if (N <= 0 || KVH <= 0 || H % KVH || hd <= 0 || hd > 256 ||
      (quant && (!ks || !vs)))
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  if (st && (n_band <= 0 || bq <= 0 || bk <= 0 || bk % kBKT ||
             (bq % kBQT && bq < kq)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* kvl = static_cast<const int*>(kvlen);
  if (dtype == spa::kBF16) {
    if (quant)
      return launch<__nv_bfloat16, int8_t>(q, k, v, qp, kss, vss, kvl, out,
                                           B, kq, H, N, KVH, hd, window,
                                           scale, soft_cap, st, n_band, bq,
                                           bk, s);
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    if (ks || !aligned ||
        !(hd == 32 || hd == 64 || hd == 128 || hd == 256))
      return (int)cudaErrorInvalidValue;
    auto tc = hd == 32    ? launch_tc<32>
              : hd == 64  ? launch_tc<64>
              : hd == 128 ? launch_tc<128>
                          : launch_tc<256>;
    return tc(q, k, v, qp, kvl, out, B, kq, H, N, KVH, window, scale,
              soft_cap, st, n_band, bq, bk, s);
  }
  if (dtype == spa::kF32) {
    return quant ? launch<float, int8_t>(q, k, v, qp, kss, vss, kvl, out, B,
                                         kq, H, N, KVH, hd, window, scale,
                                         soft_cap, st, n_band, bq, bk, s)
                 : launch<float, float>(q, k, v, qp, kss, vss, kvl, out, B, kq,
                                        H, N, KVH, hd, window, scale, soft_cap,
                                        st, n_band, bq, bk, s);
  }
  return (int)cudaErrorInvalidValue;
}
