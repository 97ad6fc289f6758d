// The Mamba-2 SSD chunked scan: per batch row and head, over chunks of cs
// steps, with the state S [hd, ds] in f32 from zero:
//
//   y_intra = ((C B^T) o exp(la_i - la_j) o 1[j<=i] o dt_j) X
//   y_inter = (C S^T) o exp(la_i)
//   S'      = exp(la_end) S + X^T (exp(la_end - la_j) dt_j o B)
//
// x [B, T, H, hd] and b, c [B, T, ds] in f32 or bf16 (b and c shared by all
// heads), dt and la [B, T, H] f32 (la the in-chunk cumulative sum of dt * a),
// y [B, T, H, hd] in x's dtype.  All arithmetic and the state are f32.
//
// Replaces: src/repro/kernels/ssd_chunk.py:ssd_chunk_scan (_ssd_kernel), one
//   head a call, a sequential grid over chunks carrying S in VMEM scratch.
// Semantics: as the Pallas kernel and the JAX model's ssd_scan, up to the
//   order of f32 sums.  The causal mask is applied before the exponential:
//   exp(la_i - la_j) is formed only for j <= i (for j > i it can overflow),
//   so no inf ever exists, where the reference masks the inf afterwards.
// Bound on the H100: bytes.  At Mamba2-370m's decode shape (x [4, 4096, 32,
//   64] bf16, ds 128, chunk 256) a call reads x, b, c, dt, la once and
//   writes y: 147 MB, 0.044 ms at 3.35 TB/s, against 26.9 GFLOP of products
//   the data needs (C B^T once per batch row and chunk, the causal half of
//   M X, C S^T and X^T (w o B)), 0.027 ms at the bf16 tensor-core peak.
// Design: chunk-parallel, in three kernels launched by one call; the only
//   sequential part is a pass of L steps over [hd, ds] states.
//   1. ssd_chunk_states: a CTA per (head, chunk but the last, batch row)
//      forms the chunk's own state S_c = (w o X)^T B [hd, ds], w_j =
//      exp(la_end - la_j) dt_j, into an f32 workspace [B, L, H, 64, 128]
//      (widths padded with zeros) that the caller allocates.
//   2. ssd_chunk_pass: a thread per 8 state elements of a (batch row,
//      head) walks the chunks, s_before[l + 1] = exp(la_end[l]) s_before[l]
//      + S_c[l] in f32 (as the reference: a product, then a sum), and
//      writes s_before over S_c in place (chunk 0's s_before, zero, is not
//      stored).
//   3. ssd_chunk_outputs: a CTA per (64-row i-tile, pair of heads, chunk,
//      batch row), the heaviest i-tiles first, computes y of its rows:
//      y = exp(la_i) (C_I s_before^T) first, then for each j-tile at or
//      before the i-tile G = C_I B_J^T once for both heads, M = G o
//      exp(la_i - la_j) o dt_j (masked to j <= i) per head, y += M X_J.
//   bf16 (the main path): every product runs on the tensor cores by wgmma
//   with f32 accumulators, one warpgroup a CTA, operands in the 128-byte
//   swizzle (csrc/hopper.cuh).  bf16 x bf16 products are exact, so G = C
//   B^T differs from the f32 reference only in the order of its sums.  Each
//   product with an f32 operand (w o X, M, s_before) issues two wgmmas
//   against the exact bf16 one, the operand split into hi = bf16(v) and lo
//   = bf16(v - hi), which keeps f32 accuracy to about 2^-17 (as P V in
//   csrc/sparse_attention.cu).  Stage 1 writes w o X as such a pair in X's
//   own layout and reads it MN-major (trans-a), B MN-major (trans-b); stage
//   2 writes s_before as the pair (per 8 elements: 8 hi, then 8 lo, in the
//   32 bytes of their f32 values); stage 3 forms G from C and B K-major,
//   splits M in the accumulator registers into the A fragments of y += M_hi
//   X + M_lo X (X read MN-major), and reads s_before K-major.  Below the
//   diagonal tile M's decay factors into exp(la_i - la_ref) exp(la_ref -
//   la_j) with la_ref the j-tile's last row: la falls within a chunk (dt >
//   0, a < 0), so both exponents are <= 0, and one exp per row and column
//   replaces one per element; the diagonal tile forms exp(la_i - la_j) per
//   element (the fast __expf, one ex2), for j <= i only.  Tiles arrive by
//   16-byte cp.async (4-byte for the dt / la columns, whose row stride is H
//   floats), double-buffered: the next unit's copies (a head's s_before,
//   or a j-tile's B and X) are issued before this unit's products.  On the
//   H100 stage 3 is bound by its CUDA-core work (M's decays and hi/lo
//   splits, the copies' addressing) at 8 warps an SM, not by its loads or
//   its products: a deeper ring (five 16 KB slots, 1.5 units ahead) and
//   forming the next head's M under this head's products were no faster,
//   so the copy loops are strength-reduced and M has one straight path
//   for the diagonal tile and one below it.  cp.async
//   and not TMA: one loader serves every width, zero-fills ragged rows and
//   padded columns by predication, and falls back to element copies where
//   a row is not 16-byte aligned (head_dim or d_state no multiple of 8).
//   Head group of 2: C B^T is formed once per (batch row, chunk, i-tile,
//   j-tile, pair of heads), B * L * 10 * 16 = 10240 times at the decode
//   shape (each head's M_hi X + M_lo X costs as much as one G).  Two heads
//   keep y (2 x 32 f32), G (32) and the split M (32) in registers and the
//   CTA at 85 KB of shared memory, so two CTAs share an SM and one's loads,
//   splits and decays overlap the other's products; the grid is 4096
//   CTAs, whose causal imbalance (i-tile 3 visits 4 j-tiles, i-tile 0 one)
//   the order of blockIdx.x, heaviest first, spreads over the 132 SMs.
//   f32: the same three stages with f32 FMAs on the CUDA cores (not the
//   tensor cores): 256 threads hold 4 x 4 outputs each, operands in padded
//   f32 shared tiles; stage 3 forms G once per pair of heads as well.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTile = 64;          // chunk rows of an i- or j-tile
constexpr int kHD = 64;            // largest head_dim, the padded width
constexpr int kDS = 128;           // largest d_state, the padded width
constexpr int kSlot = kHD * kDS;   // f32 elements of one workspace state
constexpr int kHG = 2;             // heads of an output CTA
constexpr int kWG = 128;           // threads of a bf16 CTA: one warpgroup
constexpr int kThreads = 256;      // threads of an f32 CTA: 16 x 16

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

// The first 1024-byte-aligned address of the dynamic shared memory.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// ---- bf16: wgmma kernels ---------------------------------------------------

// A 64-row bf16 tile of kCh chunks of 64 columns from a row-major source
// (row stride ld elements) into the swizzled layout (chunk c at c * 8192
// bytes), zeros outside nrows x ncols.  vec: 16-byte cp.async (rows 16-byte
// aligned, ncols a multiple of 8); else element copies.
template <int kCh>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const bf16* __restrict__ src,
                                           size_t ld, int nrows, int ncols,
                                           bool vec) {
  if (vec) {
    // a thread's unit u, chunk c and first row r0 stay fixed; its rows step
    // by a multiple of 8, so the swizzle is fixed too
    constexpr int kStep = kWG / (8 * kCh);
    const int u = threadIdx.x % 8, c = (threadIdx.x / 8) % kCh;
    const int r0 = threadIdx.x / (8 * kCh), col = c * 64 + u * 8;
    unsigned char* d = dst + c * kTile * 128 + r0 * 128 + ((u ^ (r0 & 7)) << 4);
    const bf16* s = src + r0 * ld + col;
#pragma unroll
    for (int k = 0; k < kTile / kStep; ++k) {
      const bool in = col < ncols && r0 + k * kStep < nrows;
      spa::cp_async16(d + k * kStep * 128, in ? s + k * kStep * ld : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kCh * 64; e += kWG) {
      const int r = e / (64 * kCh), col = e % (64 * kCh);
      const int c = col / 64, u = (col / 8) % 8;
      const bf16 v = r < nrows && col < ncols ? src[r * ld + col]
                                              : __float2bfloat16_rn(0.f);
      *reinterpret_cast<bf16*>(dst + c * kTile * 128 + r * 128 +
                               ((u ^ (r & 7)) << 4) + (col % 8) * 2) = v;
    }
  }
}

// (v0, v1) split into hi = bf16(v) (returned) and lo = bf16(v - hi)
__device__ __forceinline__ uint32_t pack_hi_lo(float v0, float v1,
                                               uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *lo = bf16x2_bits(
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
  return bf16x2_bits(h);
}

// a bf16 pair times w, split as pack_hi_lo
__device__ __forceinline__ uint32_t scale_hi_lo(uint32_t a, float w,
                                                uint32_t* lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  return pack_hi_lo(f.x * w, f.y * w, lo);
}

// Stage 1, grid (H, L - 1, B): S_c [64 d][128 s] of one (head, chunk,
// batch row) over the chunk's j-tiles, D = A B with A = (w o X) [M = d, K =
// j] MN-major as a hi/lo pair and B = B_J [K = j, N = s] MN-major.
constexpr int kStUnit = 16384 + 8192;  // a j-tile's B_J, then X_J
constexpr int kStSmem = 1024 + 2 * kStUnit + 2 * 8192 + 4 * kTile * 4;

__global__ void __launch_bounds__(kWG) ssd_chunk_states_bf16(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const bf16* __restrict__ bm,
    float* __restrict__ ws, int T_len, int H, int hd, int ds, int cs, int L,
    bool vec) {
  extern __shared__ unsigned char ssd_smem[];
  unsigned char* sm = aligned_smem(ssd_smem);
  unsigned char* s_ahi = sm + 2 * kStUnit;    // (w o X) hi, X's layout
  unsigned char* s_alo = s_ahi + 8192;        // (w o X) lo
  float* s_la = reinterpret_cast<float*>(s_alo + 8192);  // [2][64]
  float* s_dt = s_la + 2 * kTile;                         // [2][64]

  const int h = blockIdx.x, l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int n_tiles = (cs + kTile - 1) / kTile;
  const float la_end = la[(t0 + cs - 1) * H + h];

  auto load = [&](int jt) {
    const int j0 = jt * kTile, nj = min(kTile, cs - j0);
    unsigned char* u_s = sm + (jt & 1) * kStUnit;
    stage_rows<2>(u_s, bm + (t0 + j0) * ds, ds, nj, ds, vec);
    stage_rows<1>(u_s + 16384, x + (t0 + j0) * x_ld + (size_t)h * hd, x_ld,
                  nj, hd, vec);
    if (tid < kTile) {
      const size_t o = (t0 + j0 + tid) * H + h;
      const bool in = tid < nj;
      cp_async4(s_la + (jt & 1) * kTile + tid, in ? la + o : la, in);
      cp_async4(s_dt + (jt & 1) * kTile + tid, in ? dt + o : dt, in);
    }
    spa::cp_async_commit();
  };

  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  load(0);
  for (int jt = 0; jt < n_tiles; ++jt) {
    spa::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile jt landed; tile jt - 1's products are done
    if (jt + 1 < n_tiles) load(jt + 1);
    const int nj = min(kTile, cs - jt * kTile);
    unsigned char* u_s = sm + (jt & 1) * kStUnit;
    const float* laj = s_la + (jt & 1) * kTile;
    const float* dtj = s_dt + (jt & 1) * kTile;
    // w o X as a hi/lo pair, unit by unit in X's swizzled layout
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = tid + kWG * k, r = e / 8, u = e % 8;
      const int off = r * 128 + ((u ^ (r & 7)) << 4);
      const float w = r < nj ? expf(la_end - laj[r]) * dtj[r] : 0.f;
      const uint4 xv = *reinterpret_cast<const uint4*>(u_s + 16384 + off);
      uint4 hi, lo;
      hi.x = scale_hi_lo(xv.x, w, &lo.x);
      hi.y = scale_hi_lo(xv.y, w, &lo.y);
      hi.z = scale_hi_lo(xv.z, w, &lo.z);
      hi.w = scale_hi_lo(xv.w, w, &lo.w);
      *reinterpret_cast<uint4*>(s_ahi + off) = hi;
      *reinterpret_cast<uint4*>(s_alo + off) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 rows j a step
      const uint64_t a_hi = sw128_desc(smem_u32(s_ahi) + kk * 2048, 1024, 1024);
      const uint64_t a_lo = sw128_desc(smem_u32(s_alo) + kk * 2048, 1024, 1024);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint64_t db =
            sw128_desc(smem_u32(u_s) + c * 8192 + kk * 2048, 1024, 1024);
        wgmma_ss_n64_mn(acc[c], a_hi, db, 1);
        wgmma_ss_n64_mn(acc[c], a_lo, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
  }
  // acc[c][4j + e] is S[16 warp + g + 8 (e >> 1)][64 c + 8j + 2t + (e & 1)]
  float* slot = ws + ((size_t)(bb * L + l) * H + h) * kSlot;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half, col = 64 * c + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(slot + row * kDS + col) =
            make_float2(acc[c][4 * j + 2 * half], acc[c][4 * j + 2 * half + 1]);
      }
}

// Stage 3, grid (n_it * n_hg, L, B).  Units, each one double-buffered set
// of copies: for l > 0 first one per head of the pair (its s_before, hi and
// lo tiles [64 d][128 s]), then one per j-tile jt <= it (B_J [64 j][128 s],
// X_J [64 j][64 d] of each head, the heads' dt and la rows).
constexpr int kOutUnit = 32768;
constexpr int kOutSmall = 7 * kHG * kTile * 4;  // la_I, la_J / dt_J x 2, u, v
constexpr int kOutSmem = 1024 + 16384 + 2 * kOutUnit + kOutSmall;

__global__ void __launch_bounds__(kWG, 2) ssd_chunk_outputs_bf16(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const float* __restrict__ ws,
    bf16* __restrict__ y, int T_len, int H, int hd, int ds, int cs, int L,
    int n_hg, bool vec) {
  extern __shared__ unsigned char ssd_smem[];
  unsigned char* sm = aligned_smem(ssd_smem);
  unsigned char* s_c = sm;                   // C_I [64 i][128 s]
  unsigned char* s_units = sm + 16384;       // 2 x kOutUnit
  float* s_lai = reinterpret_cast<float*>(s_units + 2 * kOutUnit);  // [HG][64]
  float* s_laj = s_lai + kHG * kTile;        // [2][HG][64]
  float* s_dtj = s_laj + 2 * kHG * kTile;    // [2][HG][64]
  float* s_u = s_dtj + 2 * kHG * kTile;      // [HG][64] exp(la_i - la_ref)
  float* s_v = s_u + kHG * kTile;            // [HG][64] exp(la_ref - la_j) dt_j

  const int n_it = (cs + kTile - 1) / kTile;
  const int it = n_it - 1 - (int)blockIdx.x / n_hg;  // heaviest first
  const int h0 = ((int)blockIdx.x % n_hg) * kHG, nh = min(kHG, H - h0);
  const int l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int i0 = it * kTile, ni = min(kTile, cs - i0);
  const int n_inter = l > 0 ? nh : 0;
  const int n_units = n_inter + it + 1;

  auto load = [&](int u) {
    unsigned char* u_s = s_units + (u & 1) * kOutUnit;
    if (u == 0) {
      stage_rows<2>(s_c, cm + (t0 + i0) * ds, ds, ni, ds, vec);
      for (int e = tid; e < kHG * kTile; e += kWG) {
        const int hh = e / kTile, r = e % kTile;
        const bool in = hh < nh && r < ni;
        cp_async4(s_lai + e, in ? la + (t0 + i0 + r) * H + h0 + hh : la, in);
      }
    }
    if (u < n_inter) {
      // s_before of head h0 + u: group q = 16 r + 8 c + w of the state holds
      // 8 hi then 8 lo values of row d = r, columns 64 c + 8 w ..; a thread
      // copies half hl of unit w of rows r0 + 8 k in both chunks
      const unsigned char* st = reinterpret_cast<const unsigned char*>(
          ws + ((size_t)(bb * L + l) * H + h0 + u) * kSlot);
      const int hl = tid & 1, w = (tid >> 1) & 7, r0 = tid >> 4;
      unsigned char* d = u_s + hl * 16384 + r0 * 128 + ((w ^ r0) << 4);
      const unsigned char* s = st + (r0 * 16 + w) * 32 + hl * 16;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int k = 0; k < kTile / 8; ++k)
          spa::cp_async16(d + c * 8192 + k * 8 * 128,
                          s + (k * 8 * 16 + c * 8) * 32, true);
    } else {
      const int j0 = (u - n_inter) * kTile, nj = min(kTile, cs - j0);
      stage_rows<2>(u_s, bm + (t0 + j0) * ds, ds, nj, ds, vec);
      for (int hh = 0; hh < nh; ++hh)
        stage_rows<1>(u_s + 16384 + hh * 8192,
                      x + (t0 + j0) * x_ld + (size_t)(h0 + hh) * hd, x_ld, nj,
                      hd, vec);
      for (int e = tid; e < kHG * kTile; e += kWG) {
        const int hh = e / kTile, r = e % kTile;
        const bool in = hh < nh && r < nj;
        const size_t o = (t0 + j0 + r) * H + h0 + hh;
        cp_async4(s_laj + (u & 1) * kHG * kTile + e, in ? la + o : la, in);
        cp_async4(s_dtj + (u & 1) * kHG * kTile + e, in ? dt + o : dt, in);
      }
    }
    spa::cp_async_commit();
  };

  // accumulator index 4j + e: row 16 warp + g + 8 (e >> 1), column 8j + 2t +
  // (e & 1); A-fragment register r of 16-column step kk: columns 16 kk + 8
  // (r >> 1) + 2t, +1 of row g + 8 (r & 1), from accumulators 8 kk + 2r, +1
  const int row0 = 16 * warp + g;
  float yacc[kHG][32];
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[hh][i] = 0.f;
  float gacc[32];
  uint32_t m_hi[4][4], m_lo[4][4];
  const uint32_t c_addr = smem_u32(s_c);

  load(0);
  for (int u = 0; u < n_units; ++u) {
    spa::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // unit u landed; unit u - 1's readers are done
    if (u + 1 < n_units) load(u + 1);
    // unit u: S_hi and S_lo, or B_J and the heads' X_J, 16 KB each
    const uint32_t a0 = smem_u32(s_units + (u & 1) * kOutUnit);
    const uint32_t a1 = a0 + 16384;
    if (u < n_inter) {
      // y = exp(la_i) (C_I s_before^T), s_before as hi + lo, K-major
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh) {
        if (hh != u) continue;
        reg_fence(yacc[hh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDS / 16; ++kk) {
          const uint32_t k_off = (kk / 4) * 8192 + (kk % 4) * 32;
          const uint64_t da = sw128_desc(c_addr + k_off, 16, 1024);
          wgmma_ss_n64(yacc[hh], da, sw128_desc(a0 + k_off, 16, 1024), 1);
          wgmma_ss_n64(yacc[hh], da, sw128_desc(a1 + k_off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(yacc[hh]);
        const float e0 = expf(s_lai[hh * kTile + row0]);
        const float e1 = expf(s_lai[hh * kTile + row0 + 8]);
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[hh][i] *= (i >> 1) & 1 ? e1 : e0;
      }
      continue;
    }
    const int jt = u - n_inter;
    const bool diag = jt == it;
    const float* laj = s_laj + (u & 1) * kHG * kTile;
    const float* dtj = s_dtj + (u & 1) * kHG * kTile;
    if (!diag) {
      // a full j-tile below the diagonal: exp(la_i - la_j) dt_j = u_i v_j
      // about la_ref = la of the tile's last row (both exponents <= 0)
      for (int e = tid; e < kHG * kTile; e += kWG) {
        const int hh = e / kTile, r = e % kTile;
        const float ref = laj[hh * kTile + kTile - 1];
        s_u[e] = r < ni ? expf(s_lai[e] - ref) : 0.f;
        s_v[e] = expf(ref - laj[e]) * dtj[e];
      }
      __syncthreads();
    }
    // G = C_I B_J^T, both K-major
    reg_fence(gacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDS / 16; ++kk) {
      const uint32_t k_off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(gacc, sw128_desc(c_addr + k_off, 16, 1024),
                   sw128_desc(a0 + k_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(gacc);
    // y += M_hi X_J + M_lo X_J for head hh, X_J [K = j][N = d] MN-major
    auto mx = [&](int hh) {
      reg_fence(yacc[hh]);
      reg_fence(m_hi);
      reg_fence(m_lo);
      wgmma_fence();
      const uint32_t x_addr = a1 + hh * 8192;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(x_addr + kk * 2048, 1024, 1024);
        wgmma_rs_n64(yacc[hh], m_hi[kk], db);
        wgmma_rs_n64(yacc[hh], m_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(yacc[hh]);
    };
    // M of each head in the A-fragment layout, split into hi and lo
    if (diag) {
      // exp(la_i - la_j) per element (__expf: ex2 of x log2(e), within
      // 6e-6 for x >= -87), for j <= i of the chunk's rows only
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh) {
        if (hh >= nh) continue;
        const float* lj = laj + hh * kTile;
        const float* dj = dtj + hh * kTile;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row0 + 8 * (r & 1);
          const float lai = s_lai[hh * kTile + row];
          const bool live = row < ni;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int col = 16 * kk + 8 * (r >> 1) + 2 * t;
            const float2 lc = *reinterpret_cast<const float2*>(lj + col);
            const float2 dc = *reinterpret_cast<const float2*>(dj + col);
            const float m0 =
                live && col <= row
                    ? (gacc[8 * kk + 2 * r] * __expf(lai - lc.x)) * dc.x
                    : 0.f;
            const float m1 =
                live && col + 1 <= row
                    ? (gacc[8 * kk + 2 * r + 1] * __expf(lai - lc.y)) * dc.y
                    : 0.f;
            m_hi[kk][r] = pack_hi_lo(m0, m1, &m_lo[kk][r]);
          }
        }
        mx(hh);
      }
    } else {
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh) {
        if (hh >= nh) continue;
        const float u_r[2] = {s_u[hh * kTile + row0],
                              s_u[hh * kTile + row0 + 8]};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = *reinterpret_cast<const float2*>(
                s_v + hh * kTile + 16 * kk + 8 * half + 2 * t);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 2 * half + e;  // row row0 + 8 e
              m_hi[kk][r] = pack_hi_lo(
                  (gacc[8 * kk + 2 * r] * u_r[e]) * v.x,
                  (gacc[8 * kk + 2 * r + 1] * u_r[e]) * v.y, &m_lo[kk][r]);
            }
          }
        mx(hh);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kHG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= ni) continue;
      bf16* yr = y + ((t0 + i0 + row) * H + h0 + hh) * hd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = yacc[hh][4 * j + 2 * half];
        const float v1 = yacc[hh][4 * j + 2 * half + 1];
        if (col + 1 < hd && hd % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < hd) yr[col] = __float2bfloat16_rn(v0);
          if (col + 1 < hd) yr[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---- stage 2, both dtypes --------------------------------------------------

// Grid B * H * kSlot / 8 / kWG: a thread per 8 elements of one (batch row,
// head).  kSplit: s_before as a bf16 hi/lo pair (8 hi, then 8 lo, over the
// 32 bytes of the 8 f32 values), else f32.  The loads run two chunks ahead
// (S_c) and one ahead (la_end), so no step waits on its own.
template <bool kSplit>
__global__ void __launch_bounds__(kWG) ssd_chunk_pass(
    const float* __restrict__ la, float* __restrict__ ws, int B, int T_len,
    int H, int cs, int L) {
  constexpr int kGroups = kSlot / 8;
  const size_t gid = (size_t)blockIdx.x * kWG + threadIdx.x;
  const int q = (int)(gid % kGroups);
  const size_t bh = gid / kGroups;
  if (bh >= (size_t)B * H) return;
  const int h = (int)(bh % H), bb = (int)(bh / H);
  const size_t l_stride = (size_t)H * kSlot;
  float* base = ws + ((size_t)bb * L * H + h) * kSlot + 8 * q;
  const float* la_end = la + ((size_t)bb * T_len + cs - 1) * H + h;
  const size_t la_stride = (size_t)cs * H;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // S_c of chunks l (p) and l + 1 (n); chunks 0 .. L - 2 have one
  float4 p0 = reinterpret_cast<const float4*>(base)[0];
  float4 p1 = reinterpret_cast<const float4*>(base)[1];
  float4 n0 = p0, n1 = p1;
  if (L > 2) {
    n0 = reinterpret_cast<const float4*>(base + l_stride)[0];
    n1 = reinterpret_cast<const float4*>(base + l_stride)[1];
  }
  float la_next = la_end[0];
  for (int l = 0; l + 1 < L; ++l) {
    const float a = expf(la_next);
    if (l + 2 < L) la_next = la_end[(l + 1) * la_stride];
    const float c[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(__fmul_rn(a, s[i]), c[i]);
    p0 = n0;
    p1 = n1;
    if (l + 3 < L) {  // S_c of chunk l + 2, before s_before overwrites it
      const float* src = base + (l + 2) * l_stride;
      n0 = reinterpret_cast<const float4*>(src)[0];
      n1 = reinterpret_cast<const float4*>(src)[1];
    }
    float* dst = base + (l + 1) * l_stride;
    if constexpr (kSplit) {
      uint4 hi, lo;
      hi.x = pack_hi_lo(s[0], s[1], &lo.x);
      hi.y = pack_hi_lo(s[2], s[3], &lo.y);
      hi.z = pack_hi_lo(s[4], s[5], &lo.z);
      hi.w = pack_hi_lo(s[6], s[7], &lo.w);
      reinterpret_cast<uint4*>(dst)[0] = hi;
      reinterpret_cast<uint4*>(dst)[1] = lo;
    } else {
      reinterpret_cast<float4*>(dst)[0] = make_float4(s[0], s[1], s[2], s[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(s[4], s[5], s[6], s[7]);
    }
  }
}

// ---- f32: CUDA-core kernels ------------------------------------------------

constexpr int kLdS = kDS + 1;  // row strides of the shared tiles (odd)
constexpr int kLdX = kHD + 1;
constexpr int kLdM = kTile + 1;

// rows x cols tile of a row-major f32 source (row stride ld_src elements)
// into shared f32 (row stride ld), zero outside rows_valid x cols_valid
template <int kCols>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          size_t ld_src, int rows_valid,
                                          int cols_valid) {
  for (int idx = threadIdx.x; idx < kTile * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    dst[r * ld + c] =
        r < rows_valid && c < cols_valid ? src[(size_t)r * ld_src + c] : 0.f;
  }
}

// Stage 1, grid (H, L - 1, B): S_c, rows d = ty + 16 r, columns s = tx + 16 c
constexpr int kStSmemF32 = (kTile * kLdS + kTile * kLdX + kTile) * 4;

__global__ void __launch_bounds__(kThreads) ssd_chunk_states_f32(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const float* __restrict__ bm,
    float* __restrict__ ws, int T_len, int H, int hd, int ds, int cs, int L) {
  extern __shared__ float smem_f[];
  float* sB = smem_f;               // [64][ds]   B of the j-tile
  float* sX = sB + kTile * kLdS;    // [64][hd]   X of the j-tile
  float* sW = sX + kTile * kLdX;    // exp(la_end - la_j) dt_j
  const int h = blockIdx.x, l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int n_tiles = (cs + kTile - 1) / kTile;
  const float la_end = la[(t0 + cs - 1) * H + h];

  float upd[4][8] = {};
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * kTile, nj = min(kTile, cs - j0);
    __syncthreads();  // earlier readers of sB / sX / sW done
    load_tile<kDS>(sB, kLdS, bm + (t0 + j0) * ds, ds, nj, ds);
    load_tile<kHD>(sX, kLdX, x + (t0 + j0) * x_ld + (size_t)h * hd, x_ld, nj,
                   hd);
    if (tid < kTile) {
      const size_t o = (t0 + j0 + tid) * H + h;
      sW[tid] = tid < nj ? expf(la_end - la[o]) * dt[o] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const float w = sW[j];
      float xv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = sX[j * kLdX + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = sB[j * kLdS + tx + 16 * c] * w;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) upd[r][c] += xv[r] * bv[c];
    }
  }
  float* slot = ws + ((size_t)(bb * L + l) * H + h) * kSlot;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      slot[(ty + 16 * r) * kDS + tx + 16 * c] = upd[r][c];
}

// Stage 3, grid (n_it * n_hg, L, B): y of the i-tile's rows for a pair of
// heads, rows i = ty + 16 r, columns d = tx + 16 c.  sB holds B_J, or a
// head's s_before [64 d][128 s] for y_inter.
constexpr int kOutSmemF32 =
    (2 * kTile * kLdS + kTile * kLdX + kTile * kLdM + kHG * kTile +
     2 * kTile) * 4;

__global__ void __launch_bounds__(kThreads) ssd_chunk_outputs_f32(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ ws,
    float* __restrict__ y, int T_len, int H, int hd, int ds, int cs, int L,
    int n_hg) {
  extern __shared__ float smem_f[];
  float* sC = smem_f;                // [64][ds]   C of the i-tile
  float* sB = sC + kTile * kLdS;     // [64][ds]   B_J, or s_before [hd][ds]
  float* sX = sB + kTile * kLdS;     // [64][hd]   X_J of one head
  float* sM = sX + kTile * kLdX;     // [64][64]   masked M tile
  float* sLaI = sM + kTile * kLdM;   // [HG][64]
  float* sLaJ = sLaI + kHG * kTile;  // [64]
  float* sDtJ = sLaJ + kTile;        // [64]

  const int n_it = (cs + kTile - 1) / kTile;
  const int it = n_it - 1 - (int)blockIdx.x / n_hg;
  const int h0 = ((int)blockIdx.x % n_hg) * kHG, nh = min(kHG, H - h0);
  const int l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int i0 = it * kTile, ni = min(kTile, cs - i0);

  load_tile<kDS>(sC, kLdS, cm + (t0 + i0) * ds, ds, ni, ds);
  for (int e = tid; e < kHG * kTile; e += kThreads) {
    const int hh = e / kTile, r = e % kTile;
    sLaI[e] = hh < nh && r < ni ? la[(t0 + i0 + r) * H + h0 + hh] : 0.f;
  }
  float acc[kHG][4][4] = {};
  if (l > 0) {
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= nh) continue;
      __syncthreads();  // earlier readers of sB done
      load_tile<kDS>(sB, kLdS,
                     ws + ((size_t)(bb * L + l) * H + h0 + hh) * kSlot, kDS,
                     kHD, kDS);
      __syncthreads();
      // y_inter = C_I s_before^T, then o exp(la_i)
#pragma unroll 4
      for (int s = 0; s < ds; ++s) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * kLdS + s];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = sB[(tx + 16 * c) * kLdS + s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[hh][r][c] += cv[r] * sv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(sLaI[hh * kTile + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[hh][r][c] *= e;
      }
    }
  }
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile, nj = min(kTile, cs - j0);
    __syncthreads();  // earlier readers of sB done
    load_tile<kDS>(sB, kLdS, bm + (t0 + j0) * ds, ds, nj, ds);
    __syncthreads();
    // G = C_I B_J^T, once for the pair: rows i = ty + 16 r, j = tx + 16 c
    float g[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < ds; ++s) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * kLdS + s];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * kLdS + s];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] += cv[r] * bv[c];
    }
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= nh) continue;
      const int h = h0 + hh;
      __syncthreads();  // earlier readers of sX / sM / sLaJ / sDtJ done
      load_tile<kHD>(sX, kLdX, x + (t0 + j0) * x_ld + (size_t)h * hd, x_ld,
                     nj, hd);
      if (tid < kTile) {
        const bool ok = tid < nj;
        sLaJ[tid] = ok ? la[(t0 + j0 + tid) * H + h] : 0.f;
        sDtJ[tid] = ok ? dt[(t0 + j0 + tid) * H + h] : 0.f;
      }
      __syncthreads();
      // M = G o exp(la_i - la_j) o dt_j on and below the diagonal of the
      // chunk's rows only (j <= i < cs: both rows exist)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = tx + 16 * c;
          float m = 0.f;
          if (il < ni && j0 + jl <= i0 + il)
            m = (g[r][c] * expf(sLaI[hh * kTile + il] - sLaJ[jl])) *
                sDtJ[jl];
          sM[il * kLdM + jl] = m;
        }
      }
      __syncthreads();
      // y_intra += M X_J
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = sM[(ty + 16 * r) * kLdM + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[j * kLdX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[hh][r][c] += mv[r] * xv[c];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r;
      if (il >= ni) continue;
      float* yr = y + ((t0 + i0 + il) * H + h0 + hh) * hd;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) yr[d] = acc[hh][r][c];
      }
    }
  }
}

// ---- host ------------------------------------------------------------------

int launch_bf16(const bf16* x, const float* dt, const float* la,
                const bf16* b, const bf16* c, bf16* y, float* ws, int B,
                int T_len, int H, int hd, int ds, int cs, cudaStream_t s) {
  const int L = T_len / cs, n_it = (cs + kTile - 1) / kTile;
  const int n_hg = (H + kHG - 1) / kHG;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
                   hd % 8 == 0 && ds % 8 == 0;
  cudaError_t err;
  if (L > 1) {
    err = cudaFuncSetAttribute(ssd_chunk_states_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStSmem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_states_bf16<<<dim3(H, L - 1, B), kWG, kStSmem, s>>>(
        x, dt, la, b, ws, T_len, H, hd, ds, cs, L, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_chunk_pass<true><<<B * H * (kSlot / 8 / kWG), kWG, 0, s>>>(
        la, ws, B, T_len, H, cs, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(ssd_chunk_outputs_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOutSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_outputs_bf16<<<dim3(n_it * n_hg, L, B), kWG, kOutSmem, s>>>(
      x, dt, la, b, c, ws, y, T_len, H, hd, ds, cs, L, n_hg, vec);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* dt, const float* la,
               const float* b, const float* c, float* y, float* ws, int B,
               int T_len, int H, int hd, int ds, int cs, cudaStream_t s) {
  const int L = T_len / cs, n_it = (cs + kTile - 1) / kTile;
  const int n_hg = (H + kHG - 1) / kHG;
  cudaError_t err;
  if (L > 1) {
    err = cudaFuncSetAttribute(ssd_chunk_states_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStSmemF32);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_states_f32<<<dim3(H, L - 1, B), kThreads, kStSmemF32, s>>>(
        x, dt, la, b, ws, T_len, H, hd, ds, cs, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_chunk_pass<false><<<B * H * (kSlot / 8 / kWG), kWG, 0, s>>>(
        la, ws, B, T_len, H, cs, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(ssd_chunk_outputs_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOutSmemF32);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_outputs_f32<<<dim3(n_it * n_hg, L, B), kThreads, kOutSmemF32,
                          s>>>(x, dt, la, b, c, ws, y, T_len, H, hd, ds, cs,
                               L, n_hg);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, T, H, hd]; dt, la [B, T, H] f32; b, c [B, T, ds]; all
// contiguous; x, b, c, y one dtype (code); hd <= 64, ds <= 128, T a
// multiple of the chunk cs.  ws: the f32 workspace [B, T / cs, H, 64, 128]
// (the chunk states), allocated by the caller; unused (may be null) when T
// == cs.  Launches three kernels on the stream (one when T == cs).
extern "C" int spa_ssd_chunk_scan(const void* x, const void* dt,
                                  const void* la, const void* b,
                                  const void* c, void* y, void* ws, int B,
                                  int T_len, int H, int hd, int ds, int cs,
                                  int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || hd <= 0) return 0;
  if (hd > kHD || ds <= 0 || ds > kDS || cs <= 0 || T_len % cs ||
      (T_len > cs && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* laf = static_cast<const float*>(la);
  float* wsf = static_cast<float*>(ws);
  if (dtype == spa::kF32)
    return launch_f32(static_cast<const float*>(x), dtf, laf,
                      static_cast<const float*>(b),
                      static_cast<const float*>(c), static_cast<float*>(y),
                      wsf, B, T_len, H, hd, ds, cs, s);
  if (dtype == spa::kBF16)
    return launch_bf16(static_cast<const bf16*>(x), dtf, laf,
                       static_cast<const bf16*>(b),
                       static_cast<const bf16*>(c), static_cast<bf16*>(y),
                       wsf, B, T_len, H, hd, ds, cs, s);
  return (int)cudaErrorInvalidValue;
}
