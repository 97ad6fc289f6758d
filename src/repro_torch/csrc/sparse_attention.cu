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
// Design: a block owns a tile of rows and loops over kv tiles inside the
//   block (the sequential grid axis of the TPU becomes this loop), so no
//   state crosses blocks.  The banded grid is the same body with the loop
//   bounded to [starts[i] * bk, (starts[i] + n_band) * bk): a block's rows
//   lie inside one JAX q block (bq is 512, or kq when there is one q
//   block).  Both grids also skip the tiles past kv_len and, with a window,
//   the tiles outside [least query position - window, greatest + window]
//   of the block's queries (kv_range).  A skipped tile is fully masked, and
//   a fully masked tile leaves (m, l, acc) as they were, so the skip
//   changes no bit and, where the band covers the window, banded equals
//   dense bit for bit.  Two variants:
//   - bf16 K/V (the main path), head_dim any multiple of 8 up to 256,
//     padded with zero columns to 32, 64, 80, 128 or 256: rows are (query,
//     head) pairs of one kv head, so a K/V tile staged once serves the whole
//     GQA group; TMA streams K/V into a 4-stage ring for two consumer
//     warpgroups of 64 rows, which run S = Q K^T and O += P V by wgmma and
//     keep S, P, the softmax state and O in registers (namespace wg below).
//     P enters P V as a bf16 hi/lo pair (two products), so it keeps f32
//     accuracy to 2^-17, as in the f32 reference.
//   - f32 K/V, or int8 K/V with dequant scales (q in f32 or bf16), head_dim
//     up to 256: 16 queries per block, 32-key tiles dequantized to f32 in
//     shared memory, exact f32 FMAs on the CUDA cores (not redesigned).
//   bf16 K/V with scales, of a head_dim that is no multiple of 8, or not
//   16-byte aligned are refused (cudaErrorInvalidValue), never run on a
//   slower path.
#include <cuda.h>

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 K/V: warp-specialised wgmma + TMA body ---------------------------
// A CTA owns kRows = 128 rows, each a (query, head) pair of one kv head and
// one batch row: row r of a q block is query r / G, head kvh * G + r % G
// (G = H / KVH), so one staged K/V tile serves every head of the GQA group.
// The rows of a CTA lie inside one JAX q block (the dense grid is one block
// of kq queries), so on the banded grid they share starts[i].
// Warps 0-7 are two consumer warpgroups of 64 rows; warps 8-11 are the
// producer warpgroup, whose first lane streams K/V tiles of kBN keys by TMA
// (a 4D tensor map over [B, N, KVH, hd], so keys past N and columns past hd
// arrive as zeros) into a ring of kStages stages guarded by full/empty
// mbarriers.  setmaxnreg moves registers from the producer (24) to the
// consumers (240).  The consumers copy Q once into shared memory by 16-byte
// cp.async; the producer starts once those copies are issued, so Q is not
// queued behind the K/V stream.  Shared tiles are rows of 64 bf16 columns
// (128 bytes) in the 128-byte swizzle, head_dim cut into such chunks;
// chunks past ceil(hd / 64) are zeroed once and never copied into, so
// head_dim is padded with zero columns up to the instantiated width HDP.
// A consumer warpgroup issues, as one wgmma group, P V of the previous tile
// and S = Q K^T of this one (S with both operands in shared memory; P V with
// P in registers as the A fragment and V read transposed), then runs the
// scale, soft cap, masks and online softmax on the S accumulator fragment
// (a row lives on the four threads of a quad: max and sum are two
// shuffles), splits P into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and
// rescales O, all in registers.  V is bf16, so both products are exact and
// P keeps f32 accuracy to 2^-17.  The two warpgroups take turns to issue
// (named barriers), so one's softmax overlaps the other's products.
// Registers at HDP = 256: O is 128 f32 a thread, S 16 and P 16 (32-key
// tiles), no spill at 240.
// Bound: the LLaDA decode grid is 128 CTAs of 8 tiles, latency- and
// HBM-bound; head_dim 256 is tensor-core-bound (S, P_hi V and P_lo V:
// 1.5x the function's operations, plus the softmax between them).
namespace wg {

constexpr int kConsumerWGs = 2;
constexpr int kRows = 64 * kConsumerWGs;           // rows per CTA
constexpr int kThreads = 128 * (kConsumerWGs + 1);  // + a producer group
constexpr int kStages = 4;

template <int HDP>
struct Cfg {
  static constexpr int kBN = HDP == 256 ? 32 : 64;  // keys per tile
  static constexpr int kNch = (HDP + 63) / 64;      // 64-column chunks
  static constexpr int kQBytes = kNch * kRows * 128;
  static constexpr int kKvBytes = kNch * kBN * 128;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  // + full/empty barriers, the rows' position range, 1024-byte alignment
  static constexpr int kSmem = kBarOff + 16 * kStages + 16 + 1024;
  static constexpr int kFull = HDP / 64;  // n64 column blocks of O
  static constexpr int kTail = HDP % 64;  // 0, 16 or 32 more columns
};

using namespace hopper;  // csrc/hopper.cuh

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) attention_bf16_wgmma(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ qpos,
    const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ out, int kq,
    int H, int N, int KVH, int hd, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk,
    int tiles_per_qb) {
  using C = Cfg<HDP>;
  constexpr int BN = C::kBN;
  constexpr int kConsumers = 128 * kConsumerWGs;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = wg_smem + (base - raw);
  const uint32_t s_q = base;
  const uint32_t s_kv = base + C::kQBytes;  // stage s: K, then V
  const uint32_t s_bar = base + C::kBarOff;  // full[s], then empty[s]
  int* rng = reinterpret_cast<int*>(sm + C::kBarOff + 16 * kStages);

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int qb = blockIdx.x / tiles_per_qb;
  const int row0 = qb * bq * G + (blockIdx.x % tiles_per_qb) * kRows;
  const int row_end = min((qb + 1) * bq, kq) * G;
  if (row0 >= row_end) return;  // a spare tile of a short last q block
  const int tid = threadIdx.x;
  const int kv_limit = kvlen ? kvlen[b] : N;
  const int nch_load = (hd + 63) / 64;  // chunks the copies fill

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_bar + 8 * s, 1);
      mbar_init(s_bar + 8 * (kStages + s), kConsumers);
    }
    rng[0] = INT_MAX;
    rng[1] = INT_MIN;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < row_end) {
    const int p = qpos[(size_t)b * kq + (row0 + tid) / G];
    atomicMin(&rng[0], p);
    atomicMax(&rng[1], p);
  }
  __syncthreads();
  int kv_lo, kv_hi;
  kv_range(starts ? starts[qb] : -1, n_band, bk, N, kv_limit, window,
           rng[0], rng[1], BN, &kv_lo, &kv_hi);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;
  const int warp = tid / 32;

  if (warp >= 4 * kConsumerWGs) {
    // ---- producer warpgroup: one lane keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    // K/V requests queue behind the consumers' Q loads
    asm volatile("bar.sync 4, %0;\n" ::"n"(kThreads) : "memory");
    if (tid == kConsumers) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          mbar_wait(s_bar + 8 * (kStages + s), ((i / kStages) - 1) & 1);
        const uint32_t full = s_bar + 8 * s;
        mbar_expect_tx(full, 2 * nch_load * BN * 128);
        const uint32_t k_s = s_kv + s * C::kStageBytes;
        const int kv0 = kv_lo + i * BN;
        for (int c = 0; c < nch_load; ++c) {
          tma_load_4d(k_s + c * BN * 128, &tm_k, full, c * 64, kvh, kv0, b);
          tma_load_4d(k_s + C::kKvBytes + c * BN * 128, &tm_v, full, c * 64,
                      kvh, kv0, b);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const uint4 zero = make_uint4(0, 0, 0, 0);
    // zero the chunks no copy fills (columns past ceil(hd / 64) * 64)
    for (int e = tid; e < kStages * 2 * (C::kNch - nch_load) * BN * 8;
         e += kConsumers) {
      const int per = (C::kNch - nch_load) * BN * 8;
      const int tile = e / per, rem = e % per;
      *reinterpret_cast<uint4*>(sm + C::kQBytes + tile * C::kKvBytes +
                                nch_load * BN * 128 + rem * 16) = zero;
    }
    // Q -> shared memory in the swizzled layout by 16-byte cp.async, every
    // copy in flight at once: thread tid copies unit tid % 8 of rows tid / 8
    // + 32 k of each chunk; columns past hd and rows past the q block are
    // zero-filled
    static_assert(kRows * 8 == 4 * kConsumers, "4 rows a thread");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = tid / 8 + 32 * k, u = tid % 8, grow = row0 + r;
      const bool row_in = grow < row_end;
      const __nv_bfloat16* src =
          row_in ? q + (((size_t)b * kq + grow / G) * H + kvh * G + grow % G)
                           * hd
                 : q;
#pragma unroll
      for (int c = 0; c < C::kNch; ++c) {
        const bool in = row_in && c * 64 + u * 8 < hd;
        spa::cp_async16(
            sm + c * kRows * 128 + r * 128 + ((u ^ (r & 7)) << 4),
            in ? src + c * 64 + u * 8 : q, in);
      }
    }
    spa::cp_async_commit();
    // the Q copies are issued: the producer may start streaming K/V
    asm volatile("bar.arrive 4, %0;\n" ::"n"(kThreads) : "memory");
    spa::cp_async_wait<0>();
    // the copies' (generic-proxy) writes -> visible to wgmma (async
    // proxy), then a barrier of the consumer threads only
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

    const int wgi = warp / 4, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int qp[2], rq[2], rh[2];
    bool live[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int grow = row0 + wgi * 64 + (warp & 3) * 16 + g + 8 * e;
      live[e] = grow < row_end;
      rq[e] = grow / G;
      rh[e] = kvh * G + grow % G;
      qp[e] = live[e] ? qpos[(size_t)b * kq + rq[e]] : (1 << 30);
    }
    const int kv_cut = min(N, kv_limit);
    float m[2] = {spa::kNegInf, spa::kNegInf}, l[2] = {0.f, 0.f};
    float o[C::kFull > 0 ? C::kFull : 1][32];
    float o_tail[C::kTail > 0 ? C::kTail / 2 : 1];
#pragma unroll
    for (int c = 0; c < C::kFull; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (C::kTail > 0 ? C::kTail / 2 : 1); ++i)
      o_tail[i] = 0.f;
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    // P of one tile, A-fragment layout of the 16-key steps
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
    const uint32_t q_wg = s_q + wgi * 64 * 128;

    // scale, soft cap, masks and the online softmax of tile i on the
    // fragment in sc (sc[4j + e] is row g + 8 (e >> 1), key kv0 + 8j + 2t
    // + (e & 1)); updates m and l, returns alpha, writes P_hi / P_lo of the
    // tile into p (register r of 16-key step kk holds keys 16 kk + 8 (r >>
    // 1) + 2t, +1 of row g + 8 (r & 1)).  Scores are kept in log2 units
    // (s * log2 e, after the soft cap), so each exponential is one ex2; a
    // masked score becomes -inf, whose ex2 is exactly 0, and leaves the
    // row max as the NEG_INF sentinel would.  The code is straight-line
    // (the uniform soft-cap test sits outside the element loops); a warp
    // whose rows all see every key of the tile skips the masks.
    auto softmax = [&](int i, float (&alpha)[2]) {
      constexpr float kLog2e = 1.4426950408889634f;
      if (soft_cap > 0.f) {
#pragma unroll
        for (int idx = 0; idx < BN / 2; ++idx)
          sc[idx] = soft_cap * tanhf(sc[idx] * scale / soft_cap) * kLog2e;
      } else {
#pragma unroll
        for (int idx = 0; idx < BN / 2; ++idx) sc[idx] *= scale * kLog2e;
      }
      // key kv0 + 8j + 2t + (e & 1) lies below kv_cut iff 8j + (e & 1) <
      // lim, and within row r's window iff |dq[r] - (8j + (e & 1))| <=
      // window
      const int kv0 = kv_lo + i * BN;
      const bool whole =
          kv0 + BN <= kv_cut &&
          (window <= 0 || (qp[0] - window <= kv0 && qp[1] - window <= kv0 &&
                           qp[0] + window >= kv0 + BN - 1 &&
                           qp[1] + window >= kv0 + BN - 1));
      if (!__all_sync(0xffffffffu, whole)) {
        const int lim = kv_cut - kv0 - 2 * t;
        const int dq[2] = {qp[0] - kv0 - 2 * t, qp[1] - kv0 - 2 * t};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e, off = 8 * j + (e & 1);
            const bool ok = off < lim && (window <= 0 ||
                                          abs(dq[e >> 1] - off) <= window);
            sc[idx] = ok ? sc[idx] : -INFINITY;
          }
      }
      float mx[2] = {spa::kNegInf, spa::kNegInf};
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx)
        mx[(idx >> 1) & 1] = fmaxf(mx[(idx >> 1) & 1], sc[idx]);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        alpha[e] = m[e] <= spa::kNegInf / 2 ? 0.f : ex2(m[e] - m_new);
        m[e] = m_new;
      }
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) {
        const int row = (idx >> 1) & 1;
        sc[idx] = ex2(sc[idx] - m[row]);
        rsum[row] += sc[idx];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 1);
        rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 2);
        l[e] = alpha[e] * l[e] + rsum[e];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
              x0 - __low2float(hi), x1 - __high2float(hi)));
        }
    };

    auto rescale_o = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int c = 0; c < C::kFull; ++c)
#pragma unroll
        for (int idx = 0; idx < 32; ++idx)
          o[c][idx] *= alpha[(idx >> 1) & 1];
      if constexpr (C::kTail > 0) {
#pragma unroll
        for (int idx = 0; idx < C::kTail / 2; ++idx)
          o_tail[idx] *= alpha[(idx >> 1) & 1];
      }
    };

    // Phase 0 issues S of tile 0; phase ph (1 <= ph < n_tiles) issues P V
    // of tile ph - 1 and S of tile ph in one wgmma group; phase n_tiles
    // issues the last P V.  After the group lands the stage of tile ph - 1
    // is released, and the softmax of tile ph runs (P into p, O rescaled).
    // The two consumer warpgroups take turns to issue their groups (named
    // barriers 2 and 3, warpgroup 0 first), so one's softmax runs while
    // the other's products keep the tensor cores busy.
    const int turn = 2 + wgi, other = 3 - wgi;
    if (wgi == 1)
      asm volatile("bar.arrive 2, %0;\n" ::"n"(kConsumers) : "memory");
    const int n_ph = n_tiles > 0 ? n_tiles + 1 : 0;
    for (int ph = 0; ph < n_ph; ++ph) {
      const bool has_pv = ph > 0, has_s = ph < n_tiles;
      const int st_s = ph % kStages, st_v = (ph + kStages - 1) % kStages;
      if (has_s) mbar_wait(s_bar + 8 * st_s, (ph / kStages) & 1);
      asm volatile("bar.sync %0, %1;\n" ::"r"(turn), "n"(kConsumers)
                   : "memory");
#pragma unroll
      for (int c = 0; c < C::kFull; ++c) reg_fence(o[c]);
      reg_fence(o_tail);
      reg_fence(p_hi);
      reg_fence(p_lo);
      reg_fence(sc);
      wgmma_fence();
      if (has_pv) {
        // O += P_hi V + P_lo V: V tile rows are keys, 16 keys = 2048 bytes
        const uint32_t v_s = s_kv + st_v * C::kStageBytes + C::kKvBytes;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t vk = v_s + kk * 16 * 128;
#pragma unroll
          for (int c = 0; c < C::kFull; ++c) {
            const uint64_t db = sw128_desc(vk + c * BN * 128, 1024, 1024);
            wgmma_rs_n64(o[c], p_hi[kk], db);
            wgmma_rs_n64(o[c], p_lo[kk], db);
          }
          if constexpr (C::kTail > 0) {
            const uint64_t db =
                sw128_desc(vk + C::kFull * BN * 128, 1024, 1024);
            wgmma_rs<C::kTail>(o_tail, p_hi[kk], db);
            wgmma_rs<C::kTail>(o_tail, p_lo[kk], db);
          }
        }
      }
      if (has_s) {
        // S = Q K^T over HDP / 16 steps of 16 columns (32 bytes of a row)
        const uint32_t k_s = s_kv + st_s * C::kStageBytes;
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint64_t da = sw128_desc(
              q_wg + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024);
          const uint64_t db = sw128_desc(
              k_s + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
          if constexpr (BN == 64) {
            wgmma_ss_n64(sc, da, db, kk > 0);
          } else {
            wgmma_ss_n32(sc, da, db, kk > 0);
          }
        }
      }
      wgmma_commit();
      asm volatile("bar.arrive %0, %1;\n" ::"r"(other), "n"(kConsumers)
                   : "memory");
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kFull; ++c) reg_fence(o[c]);
      reg_fence(o_tail);
      reg_fence(sc);
      if (has_pv)  // the stage of tile ph - 1 may be refilled
        mbar_arrive(s_bar + 8 * (kStages + st_v));
      if (has_s) {
        float alpha[2];
        softmax(ph, alpha);
        // alpha is exactly 1 where the row max did not move: skip the
        // product in a warp whose rows all kept theirs
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
          rescale_o(alpha);
      }
    }
    if (wgi == 0)  // warpgroup 1's last hand-over
      asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumers) : "memory");

    // out = O / l (rows with l == 0 output 0); column pairs 8j + 2t, +1
    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) inv[e] = 1.f / (l[e] == 0.f ? 1.f : l[e]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!live[e]) continue;
      __nv_bfloat16* orow =
          out + (((size_t)b * kq + rq[e]) * H + rh[e]) * hd;
#pragma unroll
      for (int c = 0; c < C::kFull; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * 64 + 8 * j + 2 * t;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[c][4 * j + 2 * e] * inv[e],
                                      o[c][4 * j + 2 * e + 1] * inv[e]);
        }
      if constexpr (C::kTail > 0) {
#pragma unroll
        for (int j = 0; j < C::kTail / 8; ++j) {
          const int col = C::kFull * 64 + 8 * j + 2 * t;
          if (col < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o_tail[4 * j + 2 * e] * inv[e],
                                      o_tail[4 * j + 2 * e + 1] * inv[e]);
        }
      }
    }
  }
}

// The 4D map of a [B, N, KVH, hd] bf16 cache, boxes of 64 columns x bn keys
// of one kv head and batch row, 128-byte swizzle, zeros out of bounds.
bool kv_map(EncodeTiled enc, CUtensorMap* m, const void* base, int B, int N,
            int KVH, int hd, int bn) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KVH, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)KVH * hd * 2,
                                 (cuuint64_t)N * KVH * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bn, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kvlen, void* out, int B, int kq, int H, int N, int KVH,
           int hd, int window, float scale, float soft_cap, const int* starts,
           int n_band, int bq, int bk, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<HDP>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tk, tv;
  if (!kv_map(enc, &tk, k, B, N, KVH, hd, C::kBN) ||
      !kv_map(enc, &tv, v, B, N, KVH, hd, C::kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KVH;
  const int qblock = starts ? bq : kq;  // the dense grid: one q block
  const int tiles = (qblock * G + kRows - 1) / kRows;
  const dim3 grid(((kq + qblock - 1) / qblock) * tiles, KVH, B);
  attention_bf16_wgmma<HDP><<<grid, kThreads, C::kSmem, s>>>(
      tk, tv, static_cast<const bf16*>(q), qpos, kvlen,
      static_cast<bf16*>(out), kq, H, N, KVH, hd, window, scale, soft_cap,
      starts, n_band, qblock, bk, tiles);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
// bq must be a multiple of 16 or at least kq, bk a multiple of 64.
// bf16 K/V (no scales) take a head_dim that is a multiple of 8 up to 256
// and 16-byte aligned q, k and v; anything else returns
// cudaErrorInvalidValue.
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
  if (st && (n_band <= 0 || bq <= 0 || bk <= 0 || bk % 64 ||
             (bq % kBQ && bq < kq)))
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
    if (ks || !aligned || hd % 8) return (int)cudaErrorInvalidValue;
    // head_dim padded with zero columns to the next instantiated width
    const int hp = (hd + 15) / 16 * 16;
    auto body = hp <= 32    ? wg::launch<32>
                : hp <= 64  ? wg::launch<64>
                : hp <= 80  ? wg::launch<80>
                : hp <= 128 ? wg::launch<128>
                            : wg::launch<256>;
    return body(q, k, v, qp, kvl, out, B, kq, H, N, KVH, hd, window, scale,
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
