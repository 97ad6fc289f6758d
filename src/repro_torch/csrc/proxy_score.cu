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
//   At the hybrid's shape (B=2, N=16384) x is 268 MB: 0.08 ms.
// Design (bf16): one TMA-fed wgmma GEMM, proxy_wgmma, with two epilogues.
//   x [B*N, d] is read K-major and W_r [d, r] MN-major (r contiguous), both
//   by TMA in the 128-byte swizzle (csrc/hopper.cuh), 64 columns of d a
//   stage, into a ring of stages guarded by full / empty mbarriers.  A CTA
//   is two consumer warpgroups (64 rows of a 128-row tile each, f32
//   accumulators of up to 256 columns in registers, m64nNk16 products
//   with N = r rounded up to 64, 128 or 256) and a producer warp whose
//   first thread keeps the ring full.  Columns past r and rows past B*N
//   arrive as zeros.  Up to r = 128 two CTAs share an SM (a three-stage
//   ring of 96 KB each).
//   Score epilogue (r <= 256): the CTA holds all r columns of its rows.
//   Where the row tiles do not fill the card (the slice shape has 16),
//   the host splits d across the `split` CTAs of a thread-block cluster
//   (16 x 8 = 128 CTAs there; the hybrid's 256 row tiles take split 1).
//   Each CTA stores its partial f32 tile in its own shared memory, and
//   after a cluster barrier CTA q reduces rows [q, q + 1) * 128 / split
//   from the partials of CTAs 0, 1, ..., split - 1 in that order (through
//   distributed shared memory), so the sum, and every result, is the same
//   on every run.  It then rounds p to bf16, writes p_now and forms the
//   three row sums against p_cached, one warp per row.
//   Store epilogue (any r; the wide ranks): each 128 x 256 tile of p is
//   rounded to bf16 and stored from the accumulators; the CTAs are
//   persistent over the tiles, so one tile's stores overlap the next one's
//   loads.  cosine_drift then scores p_now.
// f32: 16-row tiles and a plain FMA loop (exact f32, no TF32), with the
//   same two epilogues.
//
// proxy_score_paged (replaces src/repro/kernels/proxy_score.py:
//   proxy_score_paged) reads p_cached through a page table from a pooled
//   arena [P, page, r] instead of a dense [B, N, r] buffer.  It is the same
//   kernel body, templated only on how a row of p_cached is addressed
//   (DenseRows / PagedRows), with the same split, so its results are
//   bitwise those of proxy_score on the gathered pages.  Its bound is
//   proxy_score's.
//
// Wide ranks (r > 256: the value / query / key identifiers project onto
//   kv_dim or q_dim, 4096 for LLaDA-8B).  A CTA cannot hold a 256 < r row
//   of p, so the projection runs alone (spa_proxy_project: the store
//   epilogue) and writes the ROUNDED p_now; cosine_drift (or
//   cosine_drift_paged) then scores it.  That is the JAX semantics exactly
//   (the cosine of the rounded p), and the paged result stays bitwise the
//   dense one.  Bound at B=4, N=512, d=r=4096, bf16: operations, 68.7
//   GFLOP = 0.069 ms at 989 TFLOP/s (the bytes, 84 MB, take 0.025 ms).
//
// cosine_drift (replaces src/repro/kernels/proxy_score.py:cosine_drift):
//   rowwise cosine(x, p_cached) with no projection, the norm product
//   floored at eps, f32 sums of x.p, x.x and p.p (JAX _cosine).  x and
//   p_cached may differ in dtype (the incremental identifier scores an f32
//   x against a bf16 cache).  Bound on the H100: bytes, both rows read once:
//   at attn_in width (B=4, N=512, r=4096, bf16 both) 33.6 MB, 0.010 ms at
//   3.35 TB/s; at the incremental width (r=128, f32 x) 1.6 MB, 0.5 us, where
//   the launch dominates.
//   Redesigned.  What held the first kernel back: one warp per
//   row at every r, so at r=128 lanes 16-31 idled and a warp waited on one
//   256-byte row, then spent five shuffle stages on each of its three
//   sums; and the paged instance loaded pt[b, row / page] before it issued
//   any load of the row.  Design: G = min(32, r / 8) lanes a row (a power of
//   two), so every lane loads at r=128 and a warp scores 32 / G rows; a
//   lane holds up to 4 chunks of 8 elements of each operand in flight (at
//   r=4096 a quarter of its row); a grid of at most two CTAs an SM whose
//   groups walk contiguous row ranges one row at a time, so a small call
//   spreads over the card (at LLaDA's 2048 rows a group has one row).  A batch's x loads are issued
//   before the p_cached row is resolved, so the paged page-id load (once
//   per logical page a group enters) overlaps them.  Holding half the row
//   at r=4096 (8 chunks) measured no faster in place and slower in phase
//   3's paged case; the whole row does not fit: 2048 rows of 16 KB are the
//   card's register file.  One fixed sum order in both instances: each
//   lane over its chunks in order, then the group's butterfly of shuffles
//   (tests/test_torch_drift_groups.py emulates it).  In place (chip_smoke.py
//   phases 6-7, an NVIDIA H100 80GB HBM3 at 700 W): 11.9 us a call at
//   attn_in width (the first kernel 12.6), 2.49 at r=128 (2.53), paged in
//   the attn_in lane 8.7 (9.0).
// cosine_drift_paged (replaces src/repro/kernels/proxy_score.py:
//   cosine_drift_paged) is that kernel with PagedRows: bitwise cosine_drift
//   on the gathered pages.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps (the f32 body)
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

// ---- bf16: TMA-fed wgmma GEMM, score or store epilogue --------------------
namespace wg {

using namespace hopper;  // csrc/hopper.cuh
using bf16 = __nv_bfloat16;

constexpr int kConsumerWGs = 2;
constexpr int kRows = 64 * kConsumerWGs;             // rows of x a tile
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreadsWG = kConsumers + 32;           // + a producer warp
constexpr int kMaxSplit = 8;                          // portable cluster size

// Score epilogue: a three-stage ring, two CTAs an SM up to r = 128 (the
// partial tile reuses the ring); store epilogue (r = 256 columns a tile):
// four stages, one CTA an SM.
template <int BN, bool kScore>
struct Cfg {
  static constexpr int kXBytes = kRows * 128;         // [128 rows][64 k]
  static constexpr int kWBytes = (BN / 64) * 8192;    // BN/64 x [64 k][64 n]
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kStages = kScore ? 3 : 4;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;
  static constexpr int kLdP = BN + 8;  // row stride of the f32 partial tile
  static constexpr int kMinBlocks = BN <= 128 ? 2 : 1;
  static_assert(!kScore || kRows * kLdP * 4 <= kBarOff,
                "partial tile fits the ring");
};

// The score epilogue of one warp: rows i0 + 8 k (k < n_k) of the tile at
// row0, each the sum of the partials [kRows][kLdP] of cluster ranks 0, 1,
// ..., split - 1 in that order (kCluster: read through distributed shared
// memory; else split is 1 and the partial is this CTA's), rounded to
// bf16, written to p_now and scored against p_cached.  Rows go in batches
// of kBatch: the batch's p_cached is loaded before its first sum (the
// rows were pulled into L2 while the products ran), and every partial of
// a row before its sum, so the warp waits for few round trips.
template <int BN, bool kCluster, int kLdP, typename Rows>
__device__ __forceinline__ void score_rows(
    const float* ps, int i0, int n_k, int row0, int split, Rows pc_row,
    float* __restrict__ scores, bf16* __restrict__ pnow, int N, int r,
    float eps, int lane) {
  constexpr int kU = BN / 64;  // column pairs a lane: 64 u + 2 lane
  constexpr int kBatch = BN <= 128 ? 4 : 2;
  constexpr int kQ = kCluster ? kMaxSplit : 1;
  for (int k0 = 0; k0 < n_k; k0 += kBatch) {
    uint32_t pcv[kBatch][kU];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k >= n_k) break;
      const int row = row0 + i0 + 8 * (k0 + k), b = row / N;
      const bf16* pc = pc_row(b, row - b * N);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = 64 * u + 2 * lane;
        pcv[k][u] = c < r ? *reinterpret_cast<const uint32_t*>(pc + c) : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k >= n_k) break;
      const int i = i0 + 8 * (k0 + k), row = row0 + i;
      float2 part[kQ][kU];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = 64 * u + 2 * lane;
          const float* src = ps + i * kLdP + c;
          part[q][u] = q >= split || c >= r ? make_float2(0.f, 0.f)
                       : kCluster ? ld_dsmem_f32x2(mapa(smem_u32(src), q))
                                  : *reinterpret_cast<const float2*>(src);
        }
      bf16* prow = pnow + (size_t)row * r;
      float num = 0.f, pp = 0.f, cc = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = 64 * u + 2 * lane;
        if (c >= r) continue;
        float2 v = part[0][u];
#pragma unroll
        for (int q = 1; q < kQ; ++q)
          if (q < split) {
            v.x += part[q][u].x;
            v.y += part[q][u].y;
          }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v.x, v.y);
        *reinterpret_cast<__nv_bfloat162*>(prow + c) = pr;
        const float2 pf = __bfloat1622float2(pr);
        const float2 qf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pcv[k][u]));
        num += pf.x * qf.x;
        pp += pf.x * pf.x;
        cc += qf.x * qf.x;
        num += pf.y * qf.y;
        pp += pf.y * pf.y;
        cc += qf.y * qf.y;
      }
      num = spa::warp_sum(num);
      pp = spa::warp_sum(pp);
      cc = spa::warp_sum(cc);
      if (lane == 0) scores[row] = num / fmaxf(sqrtf(pp * cc), eps);
    }
  }
}

// A CTA of the cluster (blockIdx.x = its rank, gridDim.x = split) projects
// the 64-column stages [k_lo, k_hi) of d; blockIdx.y walks the tiles
// (row tile fastest, then 256-column tile of r for the store epilogue).
template <int BN, bool kScore, typename Rows>
__global__ void __launch_bounds__(kThreadsWG, (Cfg<BN, kScore>::kMinBlocks))
    proxy_wgmma(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, Rows pc_row,
    float* __restrict__ scores, bf16* __restrict__ pnow, int M, int N, int r,
    int n_kst, int kst_per_rank, int n_row_tiles, int n_tiles, float eps) {
  using C = Cfg<BN, kScore>;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = wg_smem + (base - raw);
  const uint32_t s_bar = base + C::kBarOff;  // full[s], then empty[s]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = gridDim.x, rank = blockIdx.x;
  const int k_lo = rank * kst_per_rank;
  const int k_hi = min(n_kst, k_lo + kst_per_rank);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(s_bar + 8 * s, 1);
      mbar_init(s_bar + 8 * (C::kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumerWGs) {
    // ---- producer warp: one thread keeps the ring full ----
    if constexpr (kScore) {
      // first pull this CTA's rows of p_cached into L2, for the score
      // epilogue once the products are done
      const int per = kRows / split;
      const int row0 = blockIdx.y * kRows + rank * per;
      for (int e = lane; e < per * 4; e += 32) {
        const int row = row0 + e / 4, off = (e % 4) * 64;  // 128-byte lines
        if (row < M && off < r) {
          const int b = row / N;
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              pc_row(b, row - b * N) + off));
        }
      }
    }
    if (tid == kConsumers) {
      int it = 0;
      for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
        const int row0 = (t % n_row_tiles) * kRows;
        const int c0 = (t / n_row_tiles) * BN;
        for (int ks = k_lo; ks < k_hi; ++ks, ++it) {
          const int s = it % C::kStages;
          if (it >= C::kStages)
            mbar_wait(s_bar + 8 * (C::kStages + s),
                      ((it / C::kStages) - 1) & 1);
          const uint32_t full = s_bar + 8 * s;
          const uint32_t st = base + s * C::kStageBytes;
          mbar_expect_tx(full, C::kStageBytes);
          tma_load_2d(st, &tm_x, full, ks * 64, row0);
#pragma unroll
          for (int cb = 0; cb < BN / 64; ++cb)
            tma_load_2d(st + C::kXBytes + cb * 8192, &tm_w, full,
                        c0 + cb * 64, ks * 64);
        }
      }
    }
    if constexpr (kScore) {
      __syncwarp();  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- two consumer warpgroups of 64 rows ----
  const int wgi = warp / 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = wgi * 64 + 16 * (warp % 4) + g;  // acc rows r_lo, r_lo + 8
  int it = 0;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int row0 = (t % n_row_tiles) * kRows;
    const int c0 = (t / n_row_tiles) * BN;
    // acc[4j + e]: row r_lo + 8 (e >> 1), column 8j + 2 t4 + (e & 1)
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int ks = k_lo; ks < k_hi; ++ks, ++it) {
      const int s = it % C::kStages;
      mbar_wait(s_bar + 8 * s, (it / C::kStages) & 1);
      const uint32_t st = base + s * C::kStageBytes;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 columns of d a product
        const uint64_t da = sw128_desc(st + wgi * 8192 + kk * 32, 16, 1024);
        const uint64_t db =
            sw128_desc(st + C::kXBytes + kk * 2048, 8192, 1024);
        wgmma_ss_kmn<BN>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      reg_fence(acc);
      if (ks > k_lo)
        mbar_arrive(s_bar + 8 * (C::kStages + (it - 1) % C::kStages));
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (k_hi > k_lo)
      mbar_arrive(s_bar + 8 * (C::kStages + (it - 1) % C::kStages));

    if constexpr (!kScore) {
      // store: p rounded to bf16, column pairs straight from the registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_lo + 8 * h;
        if (row >= M) continue;
        bf16* prow = pnow + (size_t)row * r;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c0 + 8 * j + 2 * t4;
          if (col < r)
            *reinterpret_cast<__nv_bfloat162*>(prow + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // score: this CTA's partial tile into its shared memory (the ring,
      // which every product and copy of the tile is done with); after the
      // cluster barrier rank q sums rows [q, q + 1) * per of the tile over
      // the partials of ranks 0, 1, ..., split - 1 in that order
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      float* ps = reinterpret_cast<float*>(sm);  // [kRows][kLdP]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(ps + (r_lo + 8 * h) * C::kLdP + 8 * j +
                                     2 * t4) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      cluster_sync();  // every partial of the cluster is written
      const int per = kRows / split;  // split is a power of two
      const int i0 = rank * per + warp;  // rows i0 + 8 k of the tile
      const int n_k = (min(per, M - row0 - rank * per) - warp + 7) / 8;
      if (split == 1)
        score_rows<BN, false, C::kLdP>(ps, i0, n_k, row0, 1, pc_row,
                                       scores, pnow, N, r, eps, lane);
      else
        score_rows<BN, true, C::kLdP>(ps, i0, n_k, row0, split, pc_row,
                                      scores, pnow, N, r, eps, lane);
      cluster_sync();  // no CTA leaves while another reads its partial
    }
  }
}

// The 2D map of a row-major [rows, cols] bf16 matrix, boxes of 64 columns
// x box_rows rows, 128-byte swizzle, zeros out of bounds.
bool map_2d(EncodeTiled enc, CUtensorMap* m, const void* base, int rows,
            int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split of d for the score epilogue: a power of two, about one CTA an
// SM, at most kMaxSplit and one stage of d per CTA.
int pick_split(int n_row_tiles, int n_kst) {
  const int sms = spa::sm_count();
  int split = 1;
  while (2 * split <= kMaxSplit && 2 * split <= n_kst &&
         n_row_tiles * 2 * split <= sms + n_row_tiles / 2)
    split *= 2;
  return split;
}

template <int BN, bool kScore, typename Rows>
int go(const void* x, const void* w, Rows rows, float* scores, bf16* pnow,
       int M, int N, int d, int r, float eps, cudaStream_t s) {
  using C = Cfg<BN, kScore>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tw;
  if (!map_2d(enc, &tx, x, M, d, kRows) || !map_2d(enc, &tw, w, d, r, 64))
    return (int)cudaErrorInvalidValue;
  auto kern = proxy_wgmma<BN, kScore, Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_kst = (d + 63) / 64;
  const int n_row_tiles = (M + kRows - 1) / kRows;
  const int n_tiles = n_row_tiles * (kScore ? 1 : (r + BN - 1) / BN);
  // score: one tile a cluster, d split; store: persistent, no split
  const int split = kScore ? pick_split(n_row_tiles, n_kst) : 1;
  const int per = (n_kst + split - 1) / split;
  const int ctas =
      kScore ? n_tiles : (n_tiles < spa::sm_count() ? n_tiles
                                                    : spa::sm_count());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, ctas, 1);
  cfg.blockDim = dim3(kThreadsWG, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, tx, tw, rows, scores, pnow, M,
                                 N, r, n_kst, per, n_row_tiles, n_tiles, eps);
}

}  // namespace wg

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
    const Rows<T> rows{static_cast<const T*>(pc), where...};
    float* sc = static_cast<float*>(scores);
    T* pn = static_cast<T*>(pnow);
    const int M = B * N;
    return r <= 64    ? wg::go<64, true>(x, w, rows, sc, pn, M, N, d, r, eps, s)
           : r <= 128 ? wg::go<128, true>(x, w, rows, sc, pn, M, N, d, r, eps,
                                          s)
                      : wg::go<256, true>(x, w, rows, sc, pn, M, N, d, r, eps,
                                          s);
  }
  if (dtype == spa::kF32) {
    const dim3 grid((N + kRows - 1) / kRows, B);
    proxy_score_f32<Rows<float>, true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        Rows<float>{static_cast<const float*>(pc), where...},
        static_cast<float*>(scores), static_cast<float*>(pnow), N, d, r,
        eps);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The projection alone for a wide r (> 256): p_now = x @ w rounded to x's
// dtype (bf16: the store epilogue over 128 x 256 tiles; f32: one block per
// (row tile, batch row, 256-column tile)).
int launch_project(const void* x, const void* w, void* pnow, int B, int N,
                   int d, int r, int dtype, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spa::kBF16) {
    if (r % 16 || d % 8) return (int)cudaErrorInvalidValue;
    using T = __nv_bfloat16;
    return wg::go<256, false>(x, w, DenseRows<T>{nullptr, N, r}, nullptr,
                              static_cast<T*>(pnow), B * N, N, d, r, 0.f, s);
  }
  if (dtype == spa::kF32) {
    const dim3 grid((N + kRows - 1) / kRows, B, (r + kRMax - 1) / kRMax);
    proxy_score_f32<DenseRows<float>, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        DenseRows<float>{nullptr, N, r}, nullptr,
        static_cast<float*>(pnow), N, d, r, 0.f);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// ---- cosine_drift: lane groups sized to the row --------------------------
constexpr int kDriftThreads = 256;  // 8 warps a CTA
constexpr int kDriftCtasPerSm = 2;  // the grid's CTAs an SM (one wave)
// 8-element chunks of each operand a lane has in flight (a quarter of its
// row at r=4096): half a row measured no faster in place and slower in
// phase 3's paged case (PERF.md, Findings)
constexpr int kDriftSlots = 4;

// Eight consecutive elements, loaded raw with 16-byte loads (r % 8 == 0
// and the row bases are checked by the wrapper) and read as f32 later, so
// a lane issues every load of a batch before it converts any.
template <typename T> struct Chunk8;
template <> struct Chunk8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
template <> struct Chunk8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Row g (= b * N + n) of p_cached.  Paged: the page id of the row's
// logical page is loaded when a group's rows enter that page and kept in
// (key, base) for the page's other rows.
template <typename T>
__device__ __forceinline__ const T* drift_row(const DenseRows<T>& R, int g,
                                              int, long long&, const T*&) {
  return R.pc + (long long)g * R.r;
}

template <typename T>
__device__ __forceinline__ const T* drift_row(const PagedRows<T>& R, int g,
                                              int N, long long& key,
                                              const T*& base) {
  const int b = g / N, n = g - b * N;
  const long long k = (long long)b * R.n_log + n / R.page;
  if (k != key) {
    key = k;
    base = R.arena + (size_t)R.pt[k] * R.page * R.r;
  }
  return base + (size_t)(n % R.page) * R.r;
}

// x [B*N, r] in TX.  A group of G = 2^lg lanes scores one row: lane l sums
// chunks l, l + G, l + 2G, ... (8 elements each, in order) into its f32
// num, xx and pp, then the group adds them by a butterfly of shuffles
// (offsets G/2, ..., 1).  Group q scores rows [q * rpg, q * rpg + rpg), one
// at a time, each row's chunks in batches of kC: the x loads of a batch,
// then the p_cached loads, all before any arithmetic.
template <typename TX, typename TC, typename Rows, int kC>
__global__ void __launch_bounds__(kDriftThreads, kDriftCtasPerSm)
    cosine_drift_kernel(const TX* __restrict__ x, Rows pc_rows,
                        float* __restrict__ scores, int BN, int N, int r,
                        int lg, int rpg, float eps) {
  const int G = 1 << lg;
  const int gl = threadIdx.x & (G - 1);
  const int step = 8 * G;  // elements from one of a lane's chunks to the next
  const int lo = (blockIdx.x * (kDriftThreads >> lg) + (threadIdx.x >> lg)) *
                 rpg;
  const int hi = min(lo + rpg, BN);
  long long key = -1;
  const TC* base = nullptr;
  for (int it = 0; it < rpg; ++it) {
    const int g = lo + it;
    const bool live = g < hi;  // the same for every lane of the group
    const TX* xr = x + (long long)g * r + gl * 8;
    float num = 0.f, xx = 0.f, pp = 0.f;
    const TC* pr = nullptr;  // the row of p_cached, resolved after x's loads
    for (int c0 = 0; c0 < r; c0 += kC * step) {
      Chunk8<TX> a[kC];
      Chunk8<TC> p[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (live && c0 + i * step + gl * 8 < r) a[i].load(xr + c0 + i * step);
      if (c0 == 0 && live) pr = drift_row(pc_rows, g, N, key, base) + gl * 8;
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (live && c0 + i * step + gl * 8 < r) p[i].load(pr + c0 + i * step);
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (live && c0 + i * step + gl * 8 < r) {
          float av[8], pv[8];
          a[i].get(av);
          p[i].get(pv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            num = fmaf(av[e], pv[e], num);
            xx = fmaf(av[e], av[e], xx);
            pp = fmaf(pv[e], pv[e], pp);
          }
        }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, o);
      xx += __shfl_xor_sync(0xffffffffu, xx, o);
      pp += __shfl_xor_sync(0xffffffffu, pp, o);
    }
    if (gl == 0 && live) scores[g] = num / fmaxf(sqrtf(xx * pp), eps);
  }
}

template <typename TX, typename TC, typename Rows, int kC>
void drift_launch(unsigned grid, cudaStream_t s, const void* x, Rows rows,
                  void* scores, int bn, int N, int r, int lg, int rpg,
                  float eps) {
  cosine_drift_kernel<TX, TC, Rows, kC><<<grid, kDriftThreads, 0, s>>>(
      static_cast<const TX*>(x), rows, static_cast<float*>(scores), bn, N, r,
      lg, rpg, eps);
}

// The split: G = the largest power of two <= min(32, r / 8) lanes a row,
// the chunks a lane holds of a row rounded up to a power of two (at most
// kDriftSlots; a longer row takes several batches), and rows per group as
// few as fill kDriftCtasPerSm CTAs an SM, so small calls spread over the
// card.
template <typename TX, typename TC, typename Rows>
int drift_go(const void* x, Rows rows, void* scores, long long bn, int N,
             int r, float eps, cudaStream_t s) {
  if (bn > 0x7fffffffLL - 0xffffLL) return (int)cudaErrorInvalidValue;
  int lg = 0;
  while (lg < 5 && (16 << lg) <= r) ++lg;
  const int G = 1 << lg;
  const int cpr = (r / 8 + G - 1) / G;
  const int gpc = kDriftThreads >> lg;
  const long long max_groups =
      (long long)spa::sm_count() * kDriftCtasPerSm * gpc;
  const int rpg = (int)((bn + max_groups - 1) / max_groups);
  const long long groups = (bn + rpg - 1) / rpg;
  const unsigned grid = (unsigned)((groups + gpc - 1) / gpc);
  const int n = (int)bn;
  if (cpr <= 1)
    drift_launch<TX, TC, Rows, 1>(grid, s, x, rows, scores, n, N, r, lg, rpg,
                                  eps);
  else if (cpr <= 2)
    drift_launch<TX, TC, Rows, 2>(grid, s, x, rows, scores, n, N, r, lg, rpg,
                                  eps);
  else
    drift_launch<TX, TC, Rows, kDriftSlots>(grid, s, x, rows, scores, n, N, r,
                                            lg, rpg, eps);
  return (int)cudaGetLastError();
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
#define SPA_DRIFT(TX, TC)                                                  \
  return drift_go<TX, TC>(x, Rows<TC>{static_cast<const TC*>(pc), where...}, \
                          scores, bn, N, r, eps, s)
  if (xf && cf) SPA_DRIFT(float, float);
  if (xf && cb) SPA_DRIFT(float, bf16);
  if (xb && cf) SPA_DRIFT(bf16, float);
  if (xb && cb) SPA_DRIFT(bf16, bf16);
#undef SPA_DRIFT
  return (int)cudaErrorInvalidValue;
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
