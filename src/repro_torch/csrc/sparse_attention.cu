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
//   outside that range dropped besides the masks.  Both grids take int8 K/V
//   with per-row scales ks / vs (_attn_step dequantizes k * ks, v * vs).
// Semantics, term for term: s = (q . k) * scale, then soft_cap * tanh(s /
//   soft_cap) when soft_cap > 0; masked keys (kv_pos >= N or >= kv_len[b], or
//   |q_pos - kv_pos| > window when window > 0) score NEG_INF = -1e30 and get
//   p = 0; alpha = 0 while the running max is <= NEG_INF / 2; rows with l == 0
//   output 0; padded query rows sit at position 2^30.  GQA maps q head h to kv
//   head h / (H / KVH); int8 K/V are dequantized with per-row scales (f16, as
//   the cache holds them, or f32).
// Bound on the H100: bytes.  At B=4, N=512, 32 heads of 128, bf16, the K/V
//   cache is 33.5 MB and kq=128 gathered queries need 4.3 GFLOP: about 10 us
//   to read K/V once against about 4 us of tensor-core work.  Prefill
//   (kq = N = 512) needs 17 GFLOP against 67 MB: 20 us of bytes, 17 us of
//   operations.
// Bound of the int8 K/V path: operations.  At DeepSeek-67B's decode (B=4,
//   N=512, 64 q heads on 8 kv heads of 128, kq=128) 4 * B * kq * N * H * hd
//   = 8.6 GFLOP is 8.7 us at the bf16 peak, against 21 MB (int8 K/V 4.2 MB,
//   f16 scales 66 KB, bf16 q and out 16.8 MB), 6.3 us of bytes.  At
//   InternVL2-76B's N=1536 (same heads, kq=128) 25.8 GFLOP, 26 us, against
//   29 MB, 8.8 us.
// Bound of the banded grid at RecurrentGemma-9B's decode (B=2, N=16384, 16
//   query heads on one kv head of 256, window 2048, kq = 4096 stratified
//   queries, n_band = 26 blocks of 512): operations.  K/V are 33.5 MB, but
//   every query needs the keys of its window, 2 * 2048 + 1 = 4097 (fewer
//   at the canvas edges), in 16 heads: 4 * B * kq * H * 4097 * hd = 0.55
//   TFLOP, 0.56 ms at the bf16 peak against 0.01 ms of bytes.  (The band of
//   26 blocks is 13312 keys a query, 3.25x what the function needs.)
//   Prefill (kq = N) is 2.2 TFLOP.
// Bound of the f32-q path at LLaDA's f32 shape (B=4, N=512, 32 heads of
//   128, kq=128): 4.29 GFLOP, 0.064 ms at the f32 CUDA-core peak of 67
//   TFLOP/s (the least time for exact f32 FMAs), or 3 x 4.29 GFLOP of
//   TF32 products at 495 TFLOP/s, 0.026 ms, against 84 MB (f32 K/V 67 MB,
//   q and out 16.8 MB), 0.025 ms of bytes.  At DeepSeek-67B's int8 K/V
//   with f32 q (kq=128) 8.59 GFLOP: 0.128 ms at 67 TFLOP/s, 0.052 ms as
//   three TF32 passes.
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
//   dense bit for bit.  Three bodies, chosen by dtype:
//   - bf16 q with bf16 K/V (the main path), head_dim any multiple of 8 up
//     to 256, padded with zero columns to 32, 64, 80, 128 or 256: rows are
//     (query, head) pairs of one kv head, so a K/V tile staged once serves
//     the whole GQA group; TMA streams K/V into a 4-stage ring for two
//     consumer warpgroups of 64 rows, which run S = Q K^T and O += P V by
//     wgmma and keep S, P, the softmax state and O in registers (namespace
//     wg below).  P enters P V as a bf16 hi/lo pair (two products), so it
//     keeps f32 accuracy to 2^-17, as in the f32 reference.
//   - bf16 q with int8 K/V and scales (the int8 caches of DeepSeek-67B,
//     InternVL2-76B, Mixtral-8x22B and Qwen3-MoE): the same consumers on
//     the same ring.  The producer warpgroup streams the int8 tiles by
//     cp.async into a staging ring (half the bf16 bytes; TMA's 16-byte
//     strides do not fit every head_dim), converts them exactly to bf16
//     (|code| <= 128) into the swizzled stage, and stores the tile's
//     scales beside it.  The consumers apply ks[j] * scale to column j of
//     the f32 S accumulator, and fold vs[j] into P (P'[:, j] = p[:, j] *
//     vs[j], in f32) before the hi/lo split, so O += P' V_int8 keeps P's
//     accuracy; l sums the unscaled p.  A NaN scale poisons what it
//     poisons in the plain version: ks[j] the column's scores, vs[j] P'
//     (0 * NaN where the key is masked, as p * (v * vs) there).
//   - f32 q, with f32 K/V (scales optional) or int8 K/V and scales, any
//     head_dim up to 256 and any alignment (the f32 models: every
//     reduced() config, the trained models' decode, the CPU-parity phases
//     of chip_smoke.py): rows are (query, head) pairs of one kv head as
//     above; a producer warpgroup copies the f32 (or int8) K/V tiles by
//     cp.async, dequantizes them exactly to f32, splits each value into a
//     TF32 pair hi + lo and writes K and V^T (TF32 products read both
//     operands K-major) into a ring; one consumer warpgroup runs S = Q K^T
//     and O += P V as three TF32 products each (hi.hi + hi.lo + lo.hi: f32
//     accuracy, about 2^-21 of each term) and the softmax in f32 (namespace
//     tf below).  Chosen over exact f32 FMAs on the CUDA cores because its
//     bound is 2.5x lower (0.026 against 0.064 ms at LLaDA's f32 shape)
//     at the same accuracy class.
//   bf16 q with bf16 K/V and scales, of a head_dim that is no multiple of
//   8, or with q, k or v not 16-byte aligned are refused
//   (cudaErrorInvalidValue), never run on a slower body.
#include <cuda.h>
#include <cuda_fp16.h>

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

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

// Element i of a dequant scale array, f16 (f16 true) or f32.
__device__ __forceinline__ float load_scale(const void* p, size_t i,
                                            bool f16) {
  return f16 ? __half2float(static_cast<const __half*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// ---- bf16 q: warp-specialised wgmma body (bf16 or int8 K/V) ----------------
// A CTA owns kRows = 128 rows, each a (query, head) pair of one kv head and
// one batch row: row r of a q block is query r / G, head kvh * G + r % G
// (G = H / KVH), so one staged K/V tile serves every head of the GQA group.
// The rows of a CTA lie inside one JAX q block (the dense grid is one block
// of kq queries), so on the banded grid they share starts[i].
// Warps 0-7 are two consumer warpgroups of 64 rows; warps 8-11 are the
// producer warpgroup, which fills a ring of kStages stages of K/V tiles of
// kBN keys, guarded by full/empty mbarriers.  bf16 K/V: its first lane
// streams the tiles by TMA (a 4D tensor map over [B, N, KVH, hd], so keys
// past N and columns past hd arrive as zeros).  int8 K/V: its 128 threads
// copy the int8 tiles by cp.async into a staging ring of kRaw tiles (keys
// at or past min(N, kv_len) and columns past hd zero-filled), two tiles
// ahead, convert each to bf16 into its stage (byte permutes and an f32
// subtract, i8x4_bf16: I2F and F2F share the conversion unit with the
// consumers' ex2 and P rounding; with them the body took 1.63x the bf16
// body's time at DeepSeek's shape on an H100, with byte permutes 1.42x),
// store the tile's ks and vs (as f32) beside it, and arrive on the
// stage's full barrier, 128 arrivals.
// setmaxnreg moves registers from the producer (24; 40 for the int8
// converter) to the consumers (240; 232).  The consumers copy Q once into
// shared memory by 16-byte cp.async; the producer starts once those copies
// are issued, so Q is not queued behind the K/V stream.  Shared tiles are
// rows of 64 bf16 columns (128 bytes) in the 128-byte swizzle, head_dim cut
// into such chunks; chunks past ceil(hd / 64) are zeroed once and never
// copied into (bf16; the int8 converter writes every column up to HDP), so
// head_dim is padded with zero columns up to the instantiated width HDP.
// A consumer warpgroup issues, as one wgmma group, P V of the previous tile
// and S = Q K^T of this one (S with both operands in shared memory; P V with
// P in registers as the A fragment and V read transposed), then runs the
// scale (with int8 K/V: ks[j] * scale on column j), soft cap, masks and
// online softmax on the S accumulator fragment (a row lives on the four
// threads of a quad: max and sum are two shuffles), scales P by vs (int8
// K/V), splits P into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and rescales
// O, all in registers.  V is bf16 (or an int8 code), so both products are
// exact and P keeps f32 accuracy to 2^-17.  The two warpgroups take turns
// to issue (named barriers), so one's softmax overlaps the other's
// products.  Registers at HDP = 256: O is 128 f32 a thread, S 16 and P 16
// (32-key tiles), no spill at 240.
// Bound: the LLaDA decode grid is 128 CTAs of 8 tiles, latency- and
// HBM-bound; head_dim 256 is tensor-core-bound (S, P_hi V and P_lo V:
// 1.5x the function's operations, plus the softmax between them).  With
// int8 K/V the tiles a CTA reads are half the bytes, and each tile is
// converted once per CTA: G / 128 of a (query, head) row's share, so
// kq * G / 128 times per kv head over the grid.
namespace wg {

constexpr int kConsumerWGs = 2;
constexpr int kRows = 64 * kConsumerWGs;           // rows per CTA
constexpr int kThreads = 128 * (kConsumerWGs + 1);  // + a producer group
constexpr int kStages = 4;

template <int HDP, bool kI8>
struct Cfg {
  static constexpr int kBN = HDP == 256 ? 32 : 64;  // keys per tile
  static constexpr int kNch = (HDP + 63) / 64;      // 64-column chunks
  static constexpr int kQBytes = kNch * kRows * 128;
  static constexpr int kKvBytes = kNch * kBN * 128;  // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;
  // int8 K/V: a staging ring of kRaw int8 K+V tiles (rows of HDP bytes;
  // two at HDP = 256, where Q is 64 KB) and each stage's scales, [K: kBN |
  // V: kBN] f32
  static constexpr int kRaw = HDP == 256 ? 2 : 3;
  static constexpr int kRawOff = kQBytes + kStages * kStageBytes;
  static constexpr int kRawBytes = kI8 ? kRaw * 2 * kBN * HDP : 0;
  static constexpr int kSclOff = kRawOff + kRawBytes;
  static constexpr int kSclBytes = kI8 ? kStages * 2 * kBN * 4 : 0;
  static constexpr int kBarOff = kSclOff + kSclBytes;
  // + full/empty barriers, the rows' position range, 1024-byte alignment
  static constexpr int kSmem = kBarOff + 16 * kStages + 16 + 1024;
  static_assert(kSmem <= 232448, "over the H100's shared memory a block");
  static constexpr int kFull = HDP / 64;  // n64 column blocks of O
  static constexpr int kTail = HDP % 64;  // 0, 16 or 32 more columns
};

using namespace hopper;  // csrc/hopper.cuh

// The int8 K/V operands: codes [B, N, KVH, hd] and scales [B, N, KVH].
struct I8Args {
  const int8_t* k;
  const int8_t* v;
  const void* ks;
  const void* vs;
  bool f16;  // scales in f16, else f32
};

// The four int8 codes of w as four bf16 (two bf16x2 words), exactly and
// without the conversion unit: byte u = code + 128 is placed in the
// mantissa of 2^23 (the f32 2^23 + u), 2^23 + 128 is subtracted (exact:
// the code as an f32 with at most 8 significant bits), and the f32's upper
// half is its bf16, since its lower 16 bits are zero.
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

template <int HDP, bool kI8>
__device__ __forceinline__ void attention_body(
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, I8Args i8,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ qpos,
    const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ out, int kq,
    int H, int N, int KVH, int hd, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk,
    int tiles_per_qb) {
  using C = Cfg<HDP, kI8>;
  constexpr int BN = C::kBN;
  constexpr int kConsumers = 128 * kConsumerWGs;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = wg_smem + (base - raw);
  const uint32_t s_q = base;
  const uint32_t s_kv = base + C::kQBytes;  // stage s: K, then V
  const uint32_t s_bar = base + C::kBarOff;  // full[s], then empty[s]
  float* scl = reinterpret_cast<float*>(sm + C::kSclOff);  // int8 K/V
  int* rng = reinterpret_cast<int*>(sm + C::kBarOff + 16 * kStages);

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int qb = blockIdx.x / tiles_per_qb;
  const int row0 = qb * bq * G + (blockIdx.x % tiles_per_qb) * kRows;
  const int row_end = min((qb + 1) * bq, kq) * G;
  if (row0 >= row_end) return;  // a spare tile of a short last q block
  const int tid = threadIdx.x;
  const int kv_limit = kvlen ? kvlen[b] : N;
  const int kv_cut = min(N, kv_limit);
  const int nch_load = (hd + 63) / 64;  // chunks the copies fill

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_bar + 8 * s, kI8 ? 128 : 1);
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
    // ---- producer warpgroup: keeps the ring full ----
    if constexpr (kI8) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    // K/V requests queue behind the consumers' Q loads
    asm volatile("bar.sync 4, %0;\n" ::"n"(kThreads) : "memory");
    if constexpr (kI8) {
      const int pt = tid - kConsumers;  // 0 .. 127
      // 16-byte copies where every key row starts 16-byte aligned
      const bool wide = hd % 16 == 0;
      const int ub = wide ? 16 : 8, upr = HDP / ub;  // units a staged row
      const size_t head0 = ((size_t)b * N * KVH + kvh) * hd;
      const size_t key_stride = (size_t)KVH * hd;
      // the int8 K+V of tile i into staging slot i % kRaw; one commit
      // group a call (empty past the last tile)
      auto stage_raw = [&](int i) {
        if (i < n_tiles) {
          const int kv0 = kv_lo + i * BN;
          const uint32_t rk =
              base + C::kRawOff + (i % C::kRaw) * 2 * BN * HDP;
          for (int e = pt; e < BN * upr; e += 128) {
            const int j = e / upr, col = (e % upr) * ub, p = kv0 + j;
            const bool ok = p < kv_cut && col < hd;
            const size_t off = ok ? head0 + (size_t)p * key_stride + col : 0;
            const uint32_t dst = rk + j * HDP + col;
            if (wide) {
              cp_async16(dst, i8.k + off, ok);
              cp_async16(dst + BN * HDP, i8.v + off, ok);
            } else {
              cp_async8(dst, i8.k + off, ok);
              cp_async8(dst + BN * HDP, i8.v + off, ok);
            }
          }
        }
        spa::cp_async_commit();
      };
      // thread pt's scale of tile i: ks of key pt, or vs of key pt - BN;
      // keys past N scale 0 (their codes are zero and their p is 0), keys
      // past kv_len keep theirs (a NaN vs there poisons P', as in plain)
      auto tile_scale = [&](int i) -> float {
        const int j = pt % BN, p = kv_lo + i * BN + j;
        if (i >= n_tiles || pt >= 2 * BN || p >= N) return 0.f;
        return load_scale(pt < BN ? i8.ks : i8.vs,
                          ((size_t)b * N + p) * KVH + kvh, i8.f16);
      };
      float scale_next = tile_scale(0);
      for (int i = 0; i < C::kRaw - 1; ++i) stage_raw(i);
      for (int i = 0; i < n_tiles; ++i) {
        // tile i's copies landed, from every producer thread, and every
        // thread is done with slot (i - 1) % kRaw: refill it
        spa::cp_async_wait<C::kRaw - 2>();
        asm volatile("bar.sync 5, 128;\n" ::: "memory");
        stage_raw(i + C::kRaw - 1);
        const float scale_i = scale_next;
        scale_next = tile_scale(i + 1);
        const int s = i % kStages;
        if (i >= kStages)
          mbar_wait(s_bar + 8 * (kStages + s), ((i / kStages) - 1) & 1);
        const unsigned char* rk =
            sm + C::kRawOff + (i % C::kRaw) * 2 * BN * HDP;
        unsigned char* dk = sm + C::kQBytes + s * C::kStageBytes;
        // 16 codes (16 bytes) -> two 16-byte units (u, u + 1) of the
        // swizzled bf16 tile; every thread takes the same count
        constexpr int kPairs = BN * (HDP / 16);  // of K, then of V
        static_assert((2 * kPairs) % 128 == 0, "whole passes");
#pragma unroll 2  // a full unroll spills at the producer's 40 registers
        for (int it = 0; it < 2 * kPairs / 128; ++it) {
          const int e = pt + 128 * it;
          const int kv = e / kPairs, r = e % kPairs;
          const int j = r / (HDP / 16), u = 2 * (r % (HDP / 16));
          const uint4 w = *reinterpret_cast<const uint4*>(
              rk + kv * BN * HDP + j * HDP + u * 8);
          unsigned char* row = dk + kv * C::kKvBytes + (u / 8) * BN * 128 +
                               j * 128;
          const uint2 a = i8x4_bf16(w.x), b = i8x4_bf16(w.y);
          const uint2 c = i8x4_bf16(w.z), d = i8x4_bf16(w.w);
          *reinterpret_cast<uint4*>(row + (((u % 8) ^ (j & 7)) << 4)) =
              make_uint4(a.x, a.y, b.x, b.y);
          *reinterpret_cast<uint4*>(row + ((((u + 1) % 8) ^ (j & 7)) << 4)) =
              make_uint4(c.x, c.y, d.x, d.y);
        }
        if (pt < 2 * BN) scl[s * 2 * BN + pt] = scale_i;
        // the stage's (generic-proxy) writes -> visible to wgmma
        fence_proxy_async();
        mbar_arrive(s_bar + 8 * s);
      }
      spa::cp_async_wait<0>();
    } else if (tid == kConsumers) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          mbar_wait(s_bar + 8 * (kStages + s), ((i / kStages) - 1) & 1);
        const uint32_t full = s_bar + 8 * s;
        mbar_expect_tx(full, 2 * nch_load * BN * 128);
        const uint32_t k_s = s_kv + s * C::kStageBytes;
        const int kv0 = kv_lo + i * BN;
        for (int c = 0; c < nch_load; ++c) {
          tma_load_4d(k_s + c * BN * 128, tm_k, full, c * 64, kvh, kv0, b);
          tma_load_4d(k_s + C::kKvBytes + c * BN * 128, tm_v, full, c * 64,
                      kvh, kv0, b);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 rows ----
    if constexpr (kI8) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    }
    // zero the chunks no copy fills (columns past ceil(hd / 64) * 64)
    if constexpr (!kI8) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int e = tid; e < kStages * 2 * (C::kNch - nch_load) * BN * 8;
           e += kConsumers) {
        const int per = (C::kNch - nch_load) * BN * 8;
        const int tile = e / per, rem = e % per;
        *reinterpret_cast<uint4*>(sm + C::kQBytes + tile * C::kKvBytes +
                                  nch_load * BN * 128 + rem * 16) = zero;
      }
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
    // whose rows all see every key of the tile skips the masks.  int8 K/V:
    // the tile's scales tsc ([ks: BN | vs: BN]) multiply S's columns
    // before the scale and P's after the row sums.
    auto softmax = [&](int i, const float* tsc, float (&alpha)[2]) {
      constexpr float kLog2e = 1.4426950408889634f;
      if constexpr (kI8) {
#pragma unroll
        for (int idx = 0; idx < BN / 2; ++idx)
          sc[idx] *= tsc[8 * (idx >> 2) + 2 * t + (idx & 1)];
      }
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
      if constexpr (kI8) {
#pragma unroll
        for (int idx = 0; idx < BN / 2; ++idx)
          sc[idx] *= tsc[BN + 8 * (idx >> 2) + 2 * t + (idx & 1)];
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
        softmax(ph, scl + st_s * 2 * BN, alpha);
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

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) attention_bf16_wgmma(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ qpos,
    const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ out, int kq,
    int H, int N, int KVH, int hd, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk,
    int tiles_per_qb) {
  attention_body<HDP, false>(&tm_k, &tm_v, I8Args{}, q, qpos, kvlen, out, kq,
                             H, N, KVH, hd, window, scale, soft_cap, starts,
                             n_band, bq, bk, tiles_per_qb);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) attention_i8_wgmma(
    const I8Args i8, const __nv_bfloat16* __restrict__ q,
    const int* __restrict__ qpos, const int* __restrict__ kvlen,
    __nv_bfloat16* __restrict__ out, int kq, int H, int N, int KVH, int hd,
    int window, float scale, float soft_cap, const int* __restrict__ starts,
    int n_band, int bq, int bk, int tiles_per_qb) {
  attention_body<HDP, true>(nullptr, nullptr, i8, q, qpos, kvlen, out, kq, H,
                            N, KVH, hd, window, scale, soft_cap, starts,
                            n_band, bq, bk, tiles_per_qb);
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

// The grid of either body: q blocks x row tiles, kv heads, batch rows.
struct Grid {
  dim3 dims;
  int qblock, tiles;
};

Grid grid_of(int B, int kq, int H, int KVH, const int* starts, int bq,
             int rows) {
  const int G = H / KVH;
  const int qblock = starts ? bq : kq;  // the dense grid: one q block
  const int tiles = (qblock * G + rows - 1) / rows;
  return {dim3(((kq + qblock - 1) / qblock) * tiles, KVH, B), qblock, tiles};
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kvlen, void* out, int B, int kq, int H, int N, int KVH,
           int hd, int window, float scale, float soft_cap, const int* starts,
           int n_band, int bq, int bk, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<HDP, false>;
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
  const Grid g = grid_of(B, kq, H, KVH, starts, bq, kRows);
  attention_bf16_wgmma<HDP><<<g.dims, kThreads, C::kSmem, s>>>(
      tk, tv, static_cast<const bf16*>(q), qpos, kvlen,
      static_cast<bf16*>(out), kq, H, N, KVH, hd, window, scale, soft_cap,
      starts, n_band, g.qblock, bk, g.tiles);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_i8(const void* q, const I8Args& i8, const int* qpos,
              const int* kvlen, void* out, int B, int kq, int H, int N,
              int KVH, int hd, int window, float scale, float soft_cap,
              const int* starts, int n_band, int bq, int bk, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using C = Cfg<HDP, true>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_i8_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const Grid g = grid_of(B, kq, H, KVH, starts, bq, kRows);
  attention_i8_wgmma<HDP><<<g.dims, kThreads, C::kSmem, s>>>(
      i8, static_cast<const bf16*>(q), qpos, kvlen, static_cast<bf16*>(out),
      kq, H, N, KVH, hd, window, scale, soft_cap, starts, n_band, g.qblock,
      bk, g.tiles);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---- f32 q: warp-specialised three-pass TF32 wgmma body ---------------------
// A CTA owns kRows = 64 rows, each a (query, head) pair of one kv head and
// one batch row (as in wg above), so one staged K/V tile serves the whole
// GQA group.  Warps 0-3 are one consumer warpgroup; warps 4-7 are the
// producer warpgroup.  Every operand enters the tensor cores as a TF32
// pair: x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (|x - hi - lo| <=
// 2^-22 |x|), and each product is hi.hi + hi.lo + lo.hi, the dropped
// lo.lo and rounding terms about 2^-21 of |a b|: f32 accuracy, the sums in
// the f32 accumulators.
// Consumers: Q is split once into hi / lo K-major tiles (128-byte swizzle,
// 32 columns a 128-byte row).  For each tile of kBN = 32 keys: S = Q K^T
// as three m64n32k8 products per 8 columns (both operands in shared
// memory), then the scale, soft cap, masks and online softmax on the S
// fragment in f32, term for term the plain version's (expf, not ex2),
// then O = alpha O + P V with P V as three m64nNk8 products per 8 keys,
// P split in registers (the A fragment) and V^T in shared memory.  The
// tensor cores round their f32 sums toward zero, and a long chain of
// products in one accumulator drifts: on an H100 it put f32 outputs 1.3e-5
// from the plain version at InternVL2-76B's N=1536.  So no chain is longer
// than 12 products: each 32-column chunk of S and each tile's P V (in
// slices of up to 128 columns) start from a fresh accumulator and are
// added into S and O here, in f32 rounded to nearest, as the plain
// version adds its blocks.  TF32 operands are
// K-major only, so V arrives transposed ([columns x keys]) and with its
// keys permuted within each 8-key step: the S fragment holds keys 2t and
// 2t + 1 of a step in thread t of a quad, the A fragment columns t and t
// + 4, so key 2m + o sits at position m + 4o, and P enters the product
// with no shuffle.
// Producer: the K/V tiles stream through a ring of kUnits units, a unit
// being the K (or the V) of one tile over kUW <= 128 columns, hi and lo
// halves (head_dim 256: two K and two V units a tile).  Its 128 threads
// copy a unit's raw rows by cp.async (16-byte copies where every f32 row
// is 16-byte aligned, else 4-byte; int8 codes as 4-byte words, or bytes
// where rows are not 4-byte aligned) into the unit's lo half, kLead units
// ahead, in a row-major layout whose 16-byte (int8: 4-byte) units are
// XOR-swizzled by raw_swz(key); then they read the raw values into
// registers (int8 K/V dequantized to f32 with their row's scale: exact,
// an int8 code times an f16 scale has at most 19 significant bits, and
// with f32 scales the product rounds as the plain version's), and write
// the hi / lo pair: K as K-major rows, V transposed and permuted, each
// 16-byte store of a quarter-warp to distinct banks.  Keys past N are
// zero; columns past head_dim are zero, so head_dim is padded with zero
// columns to HDP (32, 64, 96, 128 or 256).
// A consumer releases a unit once its products landed; the producer
// issues unit m + kLead (into the slot unit m + kLead - kUnits left) and
// then converts unit m, so with kLead <= kUnits - kNU it never waits on
// a unit the consumers cannot yet release.
// Registers at HDP = 256: O 128 f32 a thread, a P V slice 16 (32
// columns), S 16 and one chunk partial 16, P hi / lo 32 (below it: two
// partials in flight, P V slices of a whole unit).  Shared memory:
// Q 64 KB per 128 columns of head_dim, a unit 32 KB (at 128 columns).
namespace tf {

constexpr int kRows = 64;      // one consumer warpgroup
constexpr int kThreads = 256;  // + a producer warpgroup
constexpr int kBN = 32;        // keys a tile
constexpr int kSmemMax = 232448;

template <int HDP>
struct Cfg {
  static constexpr int kUW = HDP < 128 ? HDP : 128;  // columns of a unit
  static constexpr int kNU = HDP / kUW;              // K (and V) units a tile
  static constexpr int kHalf = kUW * 128;            // bytes of hi (or lo)
  static constexpr int kUnitBytes = 2 * kHalf;
  static constexpr int kQHalf = kRows * HDP * 4;
  // + 1024-byte alignment, barriers, the scales of one unit, the rows'
  // position range
  static constexpr int kExtra = 1024 + 512;
  static constexpr int kFit = (kSmemMax - 2 * kQHalf - kExtra) / kUnitBytes;
  static constexpr int kUnits = kFit < 8 ? kFit : 8;
  static constexpr int kLead =
      kUnits - 2 * kNU - 1 > 1 ? kUnits - 2 * kNU - 1 : 1;
  static_assert(kLead <= kUnits - kNU, "the producer could wait on itself");
  static constexpr int kUnitOff = 2 * kQHalf;
  static constexpr int kBarOff = kUnitOff + kUnits * kUnitBytes;
  static constexpr int kSclOff = kBarOff + 16 * kUnits;
  static constexpr int kRngOff = kSclOff + 4 * kBN;
  static constexpr int kSmem = kRngOff + 16 + 1024;
  static_assert(kSmem <= kSmemMax, "over the H100's shared memory a block");
};

using namespace hopper;

// The K/V operands: f32 rows, or int8 codes, with per-row scales (int8;
// optional for f32: nullptr means unit scales).
struct KV {
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  bool f16;   // scales in f16, else f32
  bool wide;  // f32: 16-byte copies; int8: 4-byte copies
};

template <int HDP, bool kI8>
__global__ void __launch_bounds__(kThreads, 1) attention_tf32_wgmma(
    const KV kv, const float* __restrict__ q, const int* __restrict__ qpos,
    const int* __restrict__ kvlen, float* __restrict__ out, int kq, int H,
    int N, int KVH, int hd, int window, float scale, float soft_cap,
    const int* __restrict__ starts, int n_band, int bq, int bk,
    int tiles_per_qb) {
  using C = Cfg<HDP>;
  constexpr int UW = C::kUW, NU = C::kNU, U = C::kUnits;
  // columns of a P V slice (its accumulator: kPW / 2 registers) and S
  // chunk partials in flight: fewer at HDP = 256, where O holds 128
  // registers a thread
  constexpr int kPW = HDP == 256 ? 32 : UW;
  constexpr int kSt = HDP == 256 ? 1 : 2;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t raw_base = smem_u32(tf_smem);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sm = tf_smem + (base - raw_base);
  const uint32_t s_bar = base + C::kBarOff;  // full[u], then empty[u]
  float* scl = reinterpret_cast<float*>(sm + C::kSclOff);
  int* rng = reinterpret_cast<int*>(sm + C::kRngOff);
  auto unit_at = [&](int slot) {
    return base + C::kUnitOff + slot * C::kUnitBytes;
  };

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int qb = blockIdx.x / tiles_per_qb;
  const int row0 = qb * bq * G + (blockIdx.x % tiles_per_qb) * kRows;
  const int row_end = min((qb + 1) * bq, kq) * G;
  if (row0 >= row_end) return;  // a spare tile of a short last q block
  const int tid = threadIdx.x;
  const int kv_limit = kvlen ? kvlen[b] : N;

  if (tid == 0) {
    for (int s = 0; s < U; ++s) {
      mbar_init(s_bar + 8 * s, 128);
      mbar_init(s_bar + 8 * (U + s), 128);
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
           rng[0], rng[1], kBN, &kv_lo, &kv_hi);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBN - 1) / kBN : 0;
  const int n_units = n_tiles * 2 * NU;

  if (tid >= 128) {
    // ---- producer warpgroup ----
    const int pt = tid - 128;
    const size_t head0 = (size_t)kvh * hd;
    const size_t key_stride = (size_t)KVH * hd;  // elements between keys
    const size_t b0 = (size_t)b * N;
    // unit n's tile, kind and column offset
    auto unit_of = [&](int n, int* kv0, bool* is_v, int* c0) {
      const int j = n % (2 * NU);
      *kv0 = kv_lo + (n / (2 * NU)) * kBN;
      *is_v = j >= NU;
      *c0 = (j % NU) * UW;
    };
    // copy unit n's raw rows into its slot's lo half; one commit group a
    // call (empty past the last unit)
    auto issue = [&](int n) {
      if (n < n_units) {
        const int slot = n % U;
        if (n >= U) mbar_wait(s_bar + 8 * (U + slot), ((n / U) - 1) & 1);
        int kv0, c0;
        bool is_v;
        unit_of(n, &kv0, &is_v, &c0);
        const uint32_t raw = unit_at(slot) + C::kHalf;
        if constexpr (!kI8) {
          const float* src = static_cast<const float*>(is_v ? kv.v : kv.k);
          if (kv.wide) {
            for (int e = pt; e < kBN * (UW / 4); e += 128) {
              const int j = e / (UW / 4), qd = e % (UW / 4), p = kv0 + j;
              const int col = c0 + 4 * qd;
              const bool ok = p < N && col < hd;
              cp_async16(raw + j * UW * 4 + ((qd ^ raw_swz(j)) << 4),
                         ok ? src + (b0 + p) * key_stride + head0 + col : src,
                         ok);
            }
          } else {
            for (int e = pt; e < kBN * UW; e += 128) {
              const int j = e / UW, c = e % UW, p = kv0 + j, col = c0 + c;
              const bool ok = p < N && col < hd;
              cp_async4(raw + j * UW * 4 + (((c / 4) ^ raw_swz(j)) << 4) +
                            (c % 4) * 4,
                        ok ? src + (b0 + p) * key_stride + head0 + col : src,
                        ok);
            }
          }
        } else {
          const int8_t* src = static_cast<const int8_t*>(is_v ? kv.v : kv.k);
          for (int e = pt; e < kBN * (UW / 4); e += 128) {
            const int j = e / (UW / 4), wd = e % (UW / 4), p = kv0 + j;
            const int col = c0 + 4 * wd;
            const uint32_t dst = raw + j * UW + ((wd ^ raw_swz(j)) << 2);
            const int8_t* row = src + (b0 + p) * key_stride + head0;
            if (kv.wide) {
              const bool ok = p < N && col < hd;
              cp_async4(dst, ok ? row + col : src, ok);
            } else {  // rows not 4-byte aligned: bytes, synchronously
              uint32_t w = 0;
              for (int i = 0; i < 4; ++i)
                if (p < N && col + i < hd)
                  w |= (uint32_t)(uint8_t)row[col + i] << (8 * i);
              asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(w)
                           : "memory");
            }
          }
        }
      }
      spa::cp_async_commit();
    };
    // the scale of key pt (< kBN) of unit n; 0 past N (its values are 0)
    auto unit_scale = [&](int n) -> float {
      if (kv.ks == nullptr || n >= n_units || pt >= kBN) return 0.f;
      int kv0, c0;
      bool is_v;
      unit_of(n, &kv0, &is_v, &c0);
      const int p = kv0 + pt;
      if (p >= N) return 0.f;
      return load_scale(is_v ? kv.vs : kv.ks, (b0 + p) * KVH + kvh, kv.f16);
    };
    float scale_next = unit_scale(0);
    for (int n = 0; n < C::kLead; ++n) issue(n);
    for (int m = 0; m < n_units; ++m) {
      issue(m + C::kLead);
      spa::cp_async_wait<C::kLead>();  // this thread's copies of unit m
      if (kv.ks != nullptr && pt < kBN) scl[pt] = scale_next;
      asm volatile("bar.sync 5, 128;\n" ::: "memory");
      int kv0, c0;
      bool is_v;
      unit_of(m, &kv0, &is_v, &c0);
      const uint32_t u_hi = unit_at(m % U);
      const unsigned char* raw = sm + (u_hi - base) + C::kHalf;
      // the four values of 16-byte unit (int8: word) qd of raw key j
      auto raw4 = [&](int j, int qd, float (&x)[4]) {
        if constexpr (kI8) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              raw + j * UW + ((qd ^ raw_swz(j)) << 2));
          const float s = scl[j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = (float)(int8_t)(w >> (8 * i)) * s;
        } else {
          const float4 f = *reinterpret_cast<const float4*>(
              raw + j * UW * 4 + ((qd ^ raw_swz(j)) << 4));
          const float s = kv.ks != nullptr ? scl[j] : 1.f;
          x[0] = kv.ks != nullptr ? f.x * s : f.x;
          x[1] = kv.ks != nullptr ? f.y * s : f.y;
          x[2] = kv.ks != nullptr ? f.z * s : f.z;
          x[3] = kv.ks != nullptr ? f.w * s : f.w;
        }
      };
      if (!is_v) {
        // K: 16-byte unit qd of key j -> chunk qd / 8, row j (K-major)
        constexpr int kPer = kBN * (UW / 4) / 128;
        float x[kPer][4];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int e = pt + 128 * r;
          raw4(e / (UW / 4), e % (UW / 4), x[r]);
        }
        asm volatile("bar.sync 5, 128;\n" ::: "memory");  // raw read
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int e = pt + 128 * r, j = e / (UW / 4), qd = e % (UW / 4);
          tf32_split_store(sm + (u_hi - base) + (qd / 8) * kBN * 128 +
                               j * 128 + (((qd % 8) ^ (j & 7)) << 4),
                           C::kHalf, x[r]);
        }
      } else {
        // V: task (column quad cq, key group kg = 2s + o) reads keys 8s +
        // 2m + o (m < 4) of columns 4cq .. 4cq + 3 and writes, for each
        // column c, the 16-byte unit kg of row c of V^T: positions 8s + 4o
        // + m
        constexpr int kTasks = 2 * UW;
        constexpr int kPer = (kTasks + 127) / 128;
        float x[kPer][4][4];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int task = pt + 128 * r;
          if (task < kTasks) {
            const int kg = task % 8, cq = task / 8;
#pragma unroll
            for (int mm = 0; mm < 4; ++mm)
              raw4(8 * (kg >> 1) + 2 * mm + (kg & 1), cq, x[r][mm]);
          }
        }
        asm volatile("bar.sync 5, 128;\n" ::: "memory");  // raw read
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int task = pt + 128 * r;
          if (task < kTasks) {
            const int kg = task % 8, cq = task / 8;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = 4 * cq + k;
              const float col[4] = {x[r][0][k], x[r][1][k], x[r][2][k],
                                    x[r][3][k]};
              tf32_split_store(
                  sm + (u_hi - base) + c * 128 + ((kg ^ (c & 7)) << 4),
                  C::kHalf, col);
            }
          }
        }
      }
      // the unit's (generic-proxy) writes -> visible to wgmma
      fence_proxy_async();
      mbar_arrive(s_bar + 8 * (m % U));
      scale_next = unit_scale(m + 1);
    }
    spa::cp_async_wait<0>();
    return;
  }

  // ---- consumer warpgroup ----
  // Q -> hi / lo K-major tiles: chunk c (32 columns) of row r at c * kRows
  // * 128 + r * 128, 16-byte unit u at (u ^ (r & 7)) << 4
  const bool q_wide =
      hd % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  for (int e = tid; e < kRows * (HDP / 4); e += 128) {
    const int r = e / (HDP / 4), qd = e % (HDP / 4), grow = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    const int col = 4 * qd;
    if (grow < row_end && col < hd) {
      const float* src =
          q + (((size_t)b * kq + grow / G) * H + kvh * G + grow % G) * hd;
      if (q_wide) {
        const float4 f = *reinterpret_cast<const float4*>(src + col);
        x[0] = f.x;
        x[1] = f.y;
        x[2] = f.z;
        x[3] = f.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < hd) x[i] = src[col + i];
      }
    }
    tf32_split_store(
        sm + (qd / 8) * kRows * 128 + r * 128 + (((qd % 8) ^ (r & 7)) << 4),
        C::kQHalf, x);
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  const int warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int qp[2], rq[2], rh[2];
  bool live[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int grow = row0 + warp * 16 + g + 8 * e;
    live[e] = grow < row_end;
    rq[e] = grow / G;
    rh[e] = kvh * G + grow % G;
    qp[e] = live[e] ? qpos[(size_t)b * kq + rq[e]] : (1 << 30);
  }
  float m[2] = {spa::kNegInf, spa::kNegInf}, l[2] = {0.f, 0.f};
  // O: slice sl (kPW columns) in o[sl * kPW / 2 ...], its accumulator
  // layout (4j + e: row g + 8 (e >> 1), column 8j + 2t + (e & 1))
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  // S of a tile, and the partial S of two 32-column chunks: the tensor
  // cores round their f32 sums toward zero, so no accumulator chain runs
  // longer than one chunk's 12 products (S) or one tile's (O); the chunks
  // and tiles are summed here in f32, rounded to nearest
  float sc[kBN / 2], st[kSt][kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kSt; ++j) st[j][i] = 0.f;
  }
  auto add_chunk = [&](int ch) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      sc[i] = ch == 0 ? st[0][i] : sc[i] + st[ch % kSt][i];
  };
  uint32_t p_hi[kBN / 8][4], p_lo[kBN / 8][4];
  float pv[kPW / 2];  // one slice of P V

  for (int i = 0; i < n_tiles; ++i) {
    // S = Q K^T: three products per 8 columns
    const int n_k = i * 2 * NU;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      mbar_wait(s_bar + 8 * ((n_k + u) % U), ((n_k + u) / U) & 1);
    // each 32-column chunk's three products into a fresh accumulator
    // (st[ch % kSt], kSt in flight), added into sc in f32 once it landed
#pragma unroll
    for (int ch = 0; ch < HDP / 32; ++ch) {
      const int u = ch / (UW / 32), c = ch % (UW / 32);
      const uint32_t qa = base + ch * kRows * 128;
      const uint32_t kb = unit_at((n_k + u) % U) + c * kBN * 128;
      reg_fence(st[ch % kSt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a_hi = sw128_desc(qa + kk * 32, 16, 1024);
        const uint64_t a_lo =
            sw128_desc(qa + C::kQHalf + kk * 32, 16, 1024);
        const uint64_t b_hi = sw128_desc(kb + kk * 32, 16, 1024);
        const uint64_t b_lo =
            sw128_desc(kb + C::kHalf + kk * 32, 16, 1024);
        wgmma_tf32_ss_n32(st[ch % kSt], a_hi, b_hi, kk > 0);
        wgmma_tf32_ss_n32(st[ch % kSt], a_hi, b_lo, 1);
        wgmma_tf32_ss_n32(st[ch % kSt], a_lo, b_hi, 1);
      }
      wgmma_commit();
      if constexpr (kSt == 1) {
        wgmma_wait<0>();
        reg_fence(st[0]);
        add_chunk(ch);
      } else if (ch > 0) {
        wgmma_wait<1>();
        reg_fence(st[(ch - 1) % 2]);
        add_chunk(ch - 1);
      }
    }
    if constexpr (kSt == 2) {
      wgmma_wait<0>();
      reg_fence(st[(HDP / 32 - 1) % 2]);
      add_chunk(HDP / 32 - 1);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
      mbar_arrive(s_bar + 8 * (U + (n_k + u) % U));

    // scale, soft cap, masks and the online softmax (the plain version's
    // terms): sc[4j + e] is row g + 8 (e >> 1), key kv0 + 8j + 2t + (e & 1)
    const int kv0 = kv_lo + i * kBN;
    uint32_t valid = 0;
    float mx[2] = {spa::kNegInf, spa::kNegInf};
#pragma unroll
    for (int idx = 0; idx < kBN / 2; ++idx) {
      const int row = (idx >> 1) & 1;
      const int p = kv0 + 8 * (idx >> 2) + 2 * t + (idx & 1);
      float s = sc[idx] * scale;
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      const bool ok = p < N && p < kv_limit &&
                      (window <= 0 || abs(qp[row] - p) <= window);
      valid |= (uint32_t)ok << idx;
      sc[idx] = ok ? s : spa::kNegInf;
      mx[row] = fmaxf(mx[row], sc[idx]);
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e]);
      alpha[e] = m[e] <= spa::kNegInf / 2 ? 0.f : expf(m[e] - m_new);
      m[e] = m_new;
    }
#pragma unroll
    for (int idx = 0; idx < kBN / 2; ++idx) {
      const int row = (idx >> 1) & 1;
      sc[idx] = (valid >> idx) & 1 ? expf(sc[idx] - m[row]) : 0.f;
      rsum[row] += sc[idx];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 1);
      rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 2);
      l[e] = alpha[e] * l[e] + rsum[e];
    }
    // P as the A fragment of each 8-key step: a0 (g, key 2t), a1 (g + 8,
    // 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      const float x[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                          sc[4 * kk + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float h = tf32_rna(x[r]);
        p_hi[kk][r] = __float_as_uint(h);
        p_lo[kk][r] = __float_as_uint(tf32_rna(x[r] - h));
      }
    }
    // O = alpha O + P V, slice by slice of kPW columns: three products
    // per 8 keys into a fresh accumulator, V^T rows of 32 keys (128 bytes)
    const int n_v = n_k + NU;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      mbar_wait(s_bar + 8 * ((n_v + u) % U), ((n_v + u) / U) & 1);
#pragma unroll
    for (int sl = 0; sl < HDP / kPW; ++sl) {
      const int u = sl / (UW / kPW);
      const uint32_t v_hi =
          unit_at((n_v + u) % U) + (sl % (UW / kPW)) * kPW * 128;
#pragma unroll
      for (int i = 0; i < kPW / 2; ++i) pv[i] = 0.f;
      reg_fence(pv);
      reg_fence(p_hi);
      reg_fence(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 8; ++kk) {
        const uint64_t b_hi = sw128_desc(v_hi + kk * 32, 16, 1024);
        const uint64_t b_lo =
            sw128_desc(v_hi + C::kHalf + kk * 32, 16, 1024);
        wgmma_tf32_rs<kPW>(pv, p_hi[kk], b_hi);
        wgmma_tf32_rs<kPW>(pv, p_hi[kk], b_lo);
        wgmma_tf32_rs<kPW>(pv, p_lo[kk], b_hi);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(pv);
#pragma unroll
      for (int i = 0; i < kPW / 2; ++i) {
        float& oi = o[sl * (kPW / 2) + i];
        oi = alpha[(i >> 1) & 1] * oi + pv[i];
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
      mbar_arrive(s_bar + 8 * (U + (n_v + u) % U));
  }

  // out = O / l (rows with l == 0 output 0); columns 8j + 2t, +1 of each
  // unit
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!live[e]) continue;
    const float den = l[e] == 0.f ? 1.f : l[e];
    float* orow = out + (((size_t)b * kq + rq[e]) * H + rh[e]) * hd;
#pragma unroll
    for (int sl = 0; sl < HDP / kPW; ++sl)
#pragma unroll
      for (int j = 0; j < kPW / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = sl * kPW + 8 * j + 2 * t + c;
          if (col < hd)
            orow[col] = o[sl * (kPW / 2) + 4 * j + 2 * e + c] / den;
        }
  }
}

template <int HDP, bool kI8>
int launch(const KV& kv, const void* q, const int* qpos, const int* kvlen,
           void* out, int B, int kq, int H, int N, int KVH, int hd,
           int window, float scale, float soft_cap, const int* starts,
           int n_band, int bq, int bk, cudaStream_t s) {
  using C = Cfg<HDP>;
  auto kern = attention_tf32_wgmma<HDP, kI8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const wg::Grid g = wg::grid_of(B, kq, H, KVH, starts, bq, kRows);
  kern<<<g.dims, kThreads, C::kSmem, s>>>(
      kv, static_cast<const float*>(q), qpos, kvlen, static_cast<float*>(out),
      kq, H, N, KVH, hd, window, scale, soft_cap, starts, n_band, g.qblock,
      bk, g.tiles);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace

// q [B,kq,H,hd]; k/v [B,N,KVH,hd] (q's dtype, or int8 with ks/vs [B,N,KVH]
// scales of scale_dtype kF16 or kF32; ks == vs == nullptr means unit
// scales); qpos [B,kq] int32; kvlen [B] int32 or nullptr (= N); out
// [B,kq,H,hd] in q's dtype.
// starts == nullptr: the dense grid.  Else the banded grid: starts
// [ceil(kq / bq)] int32 kv-block indices (of bk keys), n_band blocks each;
// bq must be a multiple of 16 or at least kq, bk a multiple of 64.
// bf16 q takes bf16 K/V (no scales) or int8 K/V (with scales), a head_dim
// that is a multiple of 8 up to 256 and 16-byte aligned q, k and v;
// anything else returns cudaErrorInvalidValue.  f32 q takes f32 K/V (with
// or without scales) or int8 K/V (with scales), any head_dim up to 256 and
// any alignment.
extern "C" int spa_sparse_attention(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* ks, const void* vs,
                                    const void* kvlen, void* out, int B,
                                    int kq, int H, int N, int KVH, int hd,
                                    int dtype, int quant, int scale_dtype,
                                    int window, float scale, float soft_cap,
                                    const void* starts, int n_band, int bq,
                                    int bk, void* stream) {
  if (B <= 0 || kq <= 0) return 0;
  if (N <= 0 || KVH <= 0 || H % KVH || hd <= 0 || hd > 256 ||
      (quant && (!ks || !vs)) ||
      (ks && scale_dtype != spa::kF32 && scale_dtype != spa::kF16))
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  if (st && (n_band <= 0 || bq <= 0 || bk <= 0 || bk % 64 ||
             (bq % 16 && bq < kq)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const bool f16 = scale_dtype == spa::kF16;
  const int* kvl = static_cast<const int*>(kvlen);
  if (dtype == spa::kBF16) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    if ((ks && !quant) || !aligned || hd % 8)
      return (int)cudaErrorInvalidValue;
    // head_dim padded with zero columns to the next instantiated width
    const int hp = (hd + 15) / 16 * 16;
    if (quant) {
      const wg::I8Args i8{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), ks, vs, f16};
      auto body = hp <= 32    ? wg::launch_i8<32>
                  : hp <= 64  ? wg::launch_i8<64>
                  : hp <= 80  ? wg::launch_i8<80>
                  : hp <= 128 ? wg::launch_i8<128>
                              : wg::launch_i8<256>;
      return body(q, i8, qp, kvl, out, B, kq, H, N, KVH, hd, window, scale,
                  soft_cap, st, n_band, bq, bk, s);
    }
    auto body = hp <= 32    ? wg::launch<32>
                : hp <= 64  ? wg::launch<64>
                : hp <= 80  ? wg::launch<80>
                : hp <= 128 ? wg::launch<128>
                            : wg::launch<256>;
    return body(q, k, v, qp, kvl, out, B, kq, H, N, KVH, hd, window, scale,
                soft_cap, st, n_band, bq, bk, s);
  }
  if (dtype == spa::kF32) {
    // f32 rows 16-byte aligned (16-byte copies), int8 rows 4-byte aligned
    // (4-byte copies)
    const uintptr_t kv_addr = reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v);
    const bool wide = quant ? hd % 4 == 0 && (kv_addr & 3) == 0
                            : hd % 4 == 0 && (kv_addr & 15) == 0;
    const tf::KV kv{k, v, ks, vs, f16, wide};
    // head_dim padded with zero columns to the next instantiated width
    if (quant) {
      auto body = hd <= 32    ? tf::launch<32, true>
                  : hd <= 64  ? tf::launch<64, true>
                  : hd <= 96  ? tf::launch<96, true>
                  : hd <= 128 ? tf::launch<128, true>
                              : tf::launch<256, true>;
      return body(kv, q, qp, kvl, out, B, kq, H, N, KVH, hd, window, scale,
                  soft_cap, st, n_band, bq, bk, s);
    }
    auto body = hd <= 32    ? tf::launch<32, false>
                : hd <= 64  ? tf::launch<64, false>
                : hd <= 96  ? tf::launch<96, false>
                : hd <= 128 ? tf::launch<128, false>
                            : tf::launch<256, false>;
    return body(kv, q, qp, kvl, out, B, kq, H, N, KVH, hd, window, scale,
                soft_cap, st, n_band, bq, bk, s);
  }
  return (int)cudaErrorInvalidValue;
}
