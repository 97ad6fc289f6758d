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
//   f32: the same three stages on the tensor cores in three-pass TF32
//   (namespace tf below), stage 1 a pair of heads a CTA.
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
      cp_async4(smem_u32(s_la + (jt & 1) * kTile + tid), in ? la + o : la,
                in);
      cp_async4(smem_u32(s_dt + (jt & 1) * kTile + tid), in ? dt + o : dt,
                in);
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
        cp_async4(smem_u32(s_lai + e),
                  in ? la + (t0 + i0 + r) * H + h0 + hh : la, in);
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
        cp_async4(smem_u32(s_laj + (u & 1) * kHG * kTile + e),
                  in ? la + o : la, in);
        cp_async4(smem_u32(s_dtj + (u & 1) * kHG * kTile + e),
                  in ? dt + o : dt, in);
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
// head).  kTf32: s_before as a TF32 pair, hi = tf32(v) over the f32 values
// and lo = tf32(v - hi) in the slot's second half (a slot of 2 kSlot
// floats); else a bf16 pair (8 hi, then 8 lo, over the 32 bytes of the 8
// f32 values).  The loads run two chunks ahead (S_c) and one ahead
// (la_end), so no step waits on its own.
template <bool kTf32>
__global__ void __launch_bounds__(kWG) ssd_chunk_pass(
    const float* __restrict__ la, float* __restrict__ ws, int B, int T_len,
    int H, int cs, int L) {
  constexpr int kGroups = kSlot / 8;
  constexpr size_t kStride = (kTf32 ? 2 : 1) * (size_t)kSlot;
  const size_t gid = (size_t)blockIdx.x * kWG + threadIdx.x;
  const int q = (int)(gid % kGroups);
  const size_t bh = gid / kGroups;
  if (bh >= (size_t)B * H) return;
  const int h = (int)(bh % H), bb = (int)(bh / H);
  const size_t l_stride = (size_t)H * kStride;
  float* base = ws + ((size_t)bb * L * H + h) * kStride + 8 * q;
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
    if constexpr (kTf32) {
      float hi[8], lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hi[i] = tf32_rna(s[i]);
        lo[i] = tf32_rna(s[i] - hi[i]);
      }
      reinterpret_cast<float4*>(dst)[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
      reinterpret_cast<float4*>(dst + kSlot)[0] =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
      reinterpret_cast<float4*>(dst + kSlot)[1] =
          make_float4(lo[4], lo[5], lo[6], lo[7]);
    } else {
      uint4 hi, lo;
      hi.x = pack_hi_lo(s[0], s[1], &lo.x);
      hi.y = pack_hi_lo(s[2], s[3], &lo.y);
      hi.z = pack_hi_lo(s[4], s[5], &lo.z);
      hi.w = pack_hi_lo(s[6], s[7], &lo.w);
      reinterpret_cast<uint4*>(dst)[0] = hi;
      reinterpret_cast<uint4*>(dst)[1] = lo;
    }
  }
}

// ---- f32: three-pass TF32 wgmma kernels -------------------------------------
// The three stages of the bf16 path, with every f32 operand entering the
// tensor cores as a TF32 pair: hi = tf32(v), lo = tf32(v - hi) (|v - hi -
// lo| <= 2^-22 |v|; hopper.cuh tf32_rna), each product hi.hi + hi.lo +
// lo.hi, the dropped lo.lo and roundings about 2^-21 of |a b|.
// TF32 wgmma reads K-major operands only (no transposed read as bf16 has),
// and the tensor cores truncate their f32 sums, which drifts over long
// chains (csrc/sparse_attention.cu, tf).  So:
//   - every product runs over one 32-K chunk from a fresh accumulator (12
//     wgmmas), and the chunks are added in f32, rounded to nearest, in K
//     order: S_c over j, G and y_inter over s, y_intra over j;
//   - operands arrive in units of one chunk, [64 rows][32 K] hi (8 KB,
//     128-byte swizzle, as a bf16 K-major tile) and lo after it, through a
//     ring filled by a producer warpgroup (threads 128-255) while the
//     consumer warpgroup (0-127) runs the products.  The producer copies
//     each unit by cp.async (16-byte copies where the rows are 16-byte
//     aligned, else 4-byte; zeros outside the rows and columns), kLead
//     units ahead, then splits it: K-major sources (C_I and B_J for G, K =
//     s) in place, each thread its own copies; sources read along K (X_J
//     for y_intra, w o X and B for S_c, K = j) are staged raw in the unit's
//     lo half and transposed as they are split, with the positions of each
//     8-K step permuted (position m + 4 o holds row 2 m + o): the order in
//     which an accumulator fragment holds G's columns (2t, 2t + 1) is then
//     the A fragment's (t, t + 4), so M passes from G's registers to the
//     product as it stands.  s_before arrives split: the pass writes the
//     pair (ssd_chunk_pass<true>) into a slot of 2 x kSlot floats.
// Stage 1 runs a pair of heads a CTA, so that B^T is split once for both
// (a ring of 8 units, 133 KB); stage 3 keeps C_I split in 64 KB for the
// CTA's life beside a ring of 9 units (214 KB; one CTA an SM either way),
// and forms M per element on the diagonal tile (j <= i only) and factored
// about the j-tile's last row below it, as the bf16 path, with expf.
namespace tf {

constexpr int kThreads1 = 384;     // stage 1: two consumers, a producer
constexpr int kThreads3 = 256;     // stage 3: a consumer, a producer
constexpr int kChunk = 8192;       // bytes of a K-major chunk [64 rows][32 K]
constexpr int kUnit = 2 * kChunk;  // a unit: its hi chunk, then its lo chunk
constexpr int kSide = 512;         // a unit's f32 side values (la, dt rows)

// Shared memory from the 1024-aligned base: kCI units of C_I, the ring of
// kUnits units, the ring's side values, la_i of the pair of heads, then the
// full / empty barriers of the ring and C_I's.
template <int kCI, int kUnits>
struct Layout {
  static constexpr int kRing = kCI * kUnit;
  static constexpr int kSideOff = kRing + kUnits * kUnit;
  static constexpr int kLaI = kSideOff + kUnits * kSide;
  static constexpr int kBar = kLaI + kHG * kTile * 4;
  static constexpr int kBytes = 1024 + kBar + 8 * (2 * kUnits + 1);
};
constexpr int kUnits1 = 8, kLead1 = 4;  // stage 1: a consumer holds 3 units
constexpr int kUnits3 = 9, kLead3 = 6;  // stage 3: the consumer holds 2
using L1 = Layout<0, kUnits1>;
using L3 = Layout<4, kUnits3>;
static_assert(L1::kBytes <= 232448, "stage 1: over a block's shared memory");
static_assert(L3::kBytes <= 232448, "stage 3: over a block's shared memory");

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Rows r < 64 and columns col0 .. col0 + 31 of a row-major f32 source (src
// at row 0, column 0; row stride ld) into the K-major chunk at dst (16-byte
// unit u of row r at r * 128 + ((u ^ (r & 7)) << 4)), zeros outside nrows
// x ncols.  The thread's units are e = pt + 128 k (split_kmajor splits the
// same ones); a copy that reads nothing names base, a valid address.
__device__ __forceinline__ void copy_kmajor(uint32_t dst, const float* src,
                                            size_t ld, int nrows, int col0,
                                            int ncols, bool vec, int pt,
                                            const float* base) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = pt + 128 * k, r = e / 8, u = e % 8, col = col0 + 4 * u;
    const uint32_t d = dst + r * 128 + ((u ^ (r & 7)) << 4);
    const float* s = src + (size_t)r * ld + col;
    if (vec) {
      const bool in = r < nrows && col < ncols;
      hopper::cp_async16(d, in ? s : base, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = r < nrows && col + i < ncols;
        hopper::cp_async4(d + 4 * i, in ? s + i : base, in);
      }
    }
  }
}

// copy_kmajor's units of this thread, split in place: hi over the value,
// lo in the chunk after it.
__device__ __forceinline__ void split_kmajor(unsigned char* chunk, int pt) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = pt + 128 * k, r = e / 8, u = e % 8;
    unsigned char* p = chunk + r * 128 + ((u ^ (r & 7)) << 4);
    const float4 f = *reinterpret_cast<const float4*>(p);
    const float x[4] = {f.x, f.y, f.z, f.w};
    tf32_split_store(p, kChunk, x);
  }
}

// Rows j < 32 and columns col0 .. col0 + 63 of a row-major f32 source into
// a raw tile at dst (row j at j * 256, 16-byte unit q at (q ^ raw_swz(j))
// << 4), zeros outside nrows x ncols.
__device__ __forceinline__ void copy_raw(uint32_t dst, const float* src,
                                         size_t ld, int nrows, int col0,
                                         int ncols, bool vec, int pt,
                                         const float* base) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = pt + 128 * k, j = e / 16, q = e % 16, col = col0 + 4 * q;
    const uint32_t d = dst + j * 256 + ((q ^ raw_swz(j)) << 4);
    const float* s = src + (size_t)j * ld + col;
    if (vec) {
      const bool in = j < nrows && col < ncols;
      hopper::cp_async16(d, in ? s : base, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = j < nrows && col + i < ncols;
        hopper::cp_async4(d + 4 * i, in ? s + i : base, in);
      }
    }
  }
}

// The raw tile [32 rows j][64 columns c] in the unit's lo half -> the
// K-major pair [64 rows c][32 K], position 8 kk + 4 o + m of a row holding
// raw row j = 8 kk + 2 m + o; with kW each value times w_j = exp(la_end -
// la_j) dt_j (side: la of the 32 rows, then dt; w = 0 past nrows).  Task
// pt: 16-byte unit jg = pt % 8 of rows c = 4 cq + k, cq = pt / 8.
template <bool kW>
__device__ __forceinline__ void transpose_split(unsigned char* unit,
                                                const float* side,
                                                float la_end, int nrows,
                                                int pt) {
  const unsigned char* raw = unit + kChunk;
  const int jg = pt % 8, cq = pt / 8;
  producer_sync();  // every producer thread's copies of the unit landed
  float x[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = 8 * (jg >> 1) + 2 * m + (jg & 1);
    const float4 f = *reinterpret_cast<const float4*>(
        raw + j * 256 + ((cq ^ raw_swz(j)) << 4));
    x[m][0] = f.x;
    x[m][1] = f.y;
    x[m][2] = f.z;
    x[m][3] = f.w;
    if constexpr (kW) {
      const float w = j < nrows ? expf(la_end - side[j]) * side[32 + j] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[m][k] *= w;
    }
  }
  producer_sync();  // every raw value read before the pair overwrites it
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * cq + k;
    const float col[4] = {x[0][k], x[1][k], x[2][k], x[3][k]};
    tf32_split_store(unit + c * 128 + ((jg ^ (c & 7)) << 4), kChunk, col);
  }
}

// d[64 x 64] (+)= A B^T over one 32-K chunk in three TF32 passes, A and B
// units (hi, then lo) at shared addresses a and b; fresh overwrites d.
__device__ __forceinline__ void mma_chunk(float (&d)[32], uint32_t a,
                                          uint32_t b, bool fresh) {
  reg_fence(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a_hi = sw128_desc(a + kk * 32, 16, 1024);
    const uint64_t a_lo = sw128_desc(a + kChunk + kk * 32, 16, 1024);
    const uint64_t b_hi = sw128_desc(b + kk * 32, 16, 1024);
    const uint64_t b_lo = sw128_desc(b + kChunk + kk * 32, 16, 1024);
    wgmma_tf32_ss_n64(d, a_hi, b_hi, fresh && kk == 0 ? 0 : 1);
    wgmma_tf32_ss_n64(d, a_hi, b_lo, 1);
    wgmma_tf32_ss_n64(d, a_lo, b_hi, 1);
  }
}

__device__ __forceinline__ void add32(float (&d)[32], const float (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += p[i];
}

// Stage 1, grid (n_hg, L - 1, B): S_c [64 d][128 s] of a pair of heads in
// one (chunk, batch row) as (w o X)^T B, K = j; three warpgroups: consumer
// c (0, 1) owns head h0 + c, the producer (threads 256-383) fills the
// ring.  Units of each 32-row half of a j-tile, in order: (w o X)^T [64 d]
// [32 j] of each head, then B^T of columns s < 64 and s >= 64, which both
// consumers read (so B is transposed once for the pair).  A ring of one
// j-tile's 8 units: slot u always holds the same kind.
__global__ void __launch_bounds__(kThreads1, 1) ssd_chunk_states_tf32(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const float* __restrict__ bm,
    float* __restrict__ ws, int T_len, int H, int hd, int ds, int cs, int L,
    bool vec) {
  constexpr int U = kUnits1;
  extern __shared__ unsigned char ssd_smem[];
  unsigned char* sm = aligned_smem(ssd_smem);
  const uint32_t base = smem_u32(sm);
  const uint32_t s_bar = base + L1::kBar;  // full[U], then empty[U]
  const int h0 = blockIdx.x * kHG, nh = min(kHG, H - h0);
  const int l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int n_units = 8 * ((cs + kTile - 1) / kTile);
  if (tid == 0) {
    for (int s = 0; s < U; ++s) {
      mbar_init(s_bar + 8 * s, 128);
      mbar_init(s_bar + 8 * (U + s), s % 4 < 2 ? 128 : 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // unit n: half n / 4 of the chunk (rows j0 .. j0 + 31; nr of them in the
  // chunk, <= 0 past its end: a unit of zeros), then X of head h0 + k (k =
  // n % 4 < 2) or B's column block k - 2
  auto unit_of = [&](int n, int* k, int* j0, int* nr) {
    *k = n % 4;
    *j0 = 32 * (n / 4);
    *nr = min(32, cs - *j0);
  };

  if (tid >= 256) {
    // ---- producer ----
    const int pt = tid - 256;
    const float la_end[2] = {la[(t0 + cs - 1) * H + h0],
                             la[(t0 + cs - 1) * H + h0 + nh - 1]};
    auto issue = [&](int n) {
      if (n < n_units) {
        const int slot = n % U;
        if (n >= U) mbar_wait(s_bar + 8 * (U + slot), ((n / U) - 1) & 1);
        int k, j0, nr;
        unit_of(n, &k, &j0, &nr);
        const uint32_t raw = base + L1::kRing + slot * kUnit + kChunk;
        if (k < 2) {  // X of head h0 + k, la then dt of its 32 rows
          const int rows = k < nh ? nr : 0;
          const int h = h0 + (k < nh ? k : 0);
          copy_raw(raw, x + (t0 + j0) * x_ld + (size_t)h * hd, x_ld, rows, 0,
                   hd, vec, pt, x);
          if (pt < 64) {
            const int r = pt % 32;
            const bool in = r < rows;
            const float* src = pt < 32 ? la : dt;
            hopper::cp_async4(base + L1::kSideOff + slot * kSide + 4 * pt,
                              in ? src + (t0 + j0 + r) * H + h : src, in);
          }
        } else {
          copy_raw(raw, bm + (t0 + j0) * ds, ds, nr, 64 * (k - 2), ds, vec,
                   pt, bm);
        }
      }
      spa::cp_async_commit();
    };
    for (int n = 0; n < kLead1; ++n) issue(n);
    for (int m = 0; m < n_units; ++m) {
      issue(m + kLead1);
      spa::cp_async_wait<kLead1>();  // this thread's copies of unit m
      const int slot = m % U;
      int k, j0, nr;
      unit_of(m, &k, &j0, &nr);
      unsigned char* unit = sm + L1::kRing + slot * kUnit;
      if (k < 2) {
        transpose_split<true>(
            unit,
            reinterpret_cast<const float*>(sm + L1::kSideOff + slot * kSide),
            la_end[k], k < nh ? nr : 0, pt);
      } else {
        transpose_split<false>(unit, nullptr, 0.f, nr, pt);
      }
      fence_proxy_async();  // the unit's writes -> visible to wgmma
      mbar_arrive(s_bar + 8 * slot);
    }
    spa::cp_async_wait<0>();
    return;
  }

  // ---- consumer c: per half, D[64 d][64 s] of both column blocks ----
  const int c = tid / 128, ct = tid % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane >> 2, t = lane & 3;
  auto wait_full = [&](int n) {
    mbar_wait(s_bar + 8 * (n % U), (n / U) & 1);
  };
  auto release = [&](int n) { mbar_arrive(s_bar + 8 * (U + n % U)); };
  auto unit_at = [&](int n) { return base + L1::kRing + (n % U) * kUnit; };
  float acc[2][32], p[2][32];
  for (int n = 0; n < n_units; n += 4) {
    wait_full(n + c);
    wait_full(n + 2);
    wait_full(n + 3);
    const uint32_t a = unit_at(n + c);
    if (n == 0) {
      mma_chunk(acc[0], a, unit_at(n + 2), true);
      mma_chunk(acc[1], a, unit_at(n + 3), true);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
    } else {
      mma_chunk(p[0], a, unit_at(n + 2), true);
      mma_chunk(p[1], a, unit_at(n + 3), true);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(p[0]);
      reg_fence(p[1]);
      add32(acc[0], p[0]);
      add32(acc[1], p[1]);
    }
    release(n + c);
    release(n + 2);
    release(n + 3);
  }
  if (c >= nh) return;
  // acc[k][4j + e] is S[16 warp + g + 8 (e >> 1)][64 k + 8j + 2t + (e & 1)]
  float* slot = ws + ((size_t)(bb * L + l) * H + h0 + c) * (2 * kSlot);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half, col = 64 * k + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(slot + row * kDS + col) =
            make_float2(acc[k][4 * j + 2 * half], acc[k][4 * j + 2 * half + 1]);
      }
}

// Stage 3, grid (n_it * n_hg, L, B), the heaviest i-tiles first.  C_I
// [64 i][128 s] is split once into 4 K-major units.  Ring units, in order:
// for l > 0 the four s-chunks of each head's s_before [64 d][32 s]; then
// for each j-tile jt <= it the four s-chunks of B_J [64 j][32 s], then for
// each head and 32-row half q of the tile X_J^T [64 d][32 j] (permuted),
// with the head's la_J and dt_J of the tile's 64 rows as side values.
__global__ void __launch_bounds__(kThreads3, 1) ssd_chunk_outputs_tf32(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ ws,
    float* __restrict__ y, int T_len, int H, int hd, int ds, int cs, int L,
    int n_hg, bool vec) {
  constexpr int U = kUnits3;
  extern __shared__ unsigned char ssd_smem[];
  unsigned char* sm = aligned_smem(ssd_smem);
  const uint32_t base = smem_u32(sm);
  const uint32_t s_bar = base + L3::kBar;  // full[U], empty[U], then C_I's
  const uint32_t c_bar = s_bar + 16 * U;
  const float* s_lai = reinterpret_cast<const float*>(sm + L3::kLaI);

  const int n_it = (cs + kTile - 1) / kTile;
  const int it = n_it - 1 - (int)blockIdx.x / n_hg;  // heaviest first
  const int h0 = ((int)blockIdx.x % n_hg) * kHG, nh = min(kHG, H - h0);
  const int l = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t t0 = (size_t)bb * T_len + (size_t)l * cs;
  const size_t x_ld = (size_t)H * hd;
  const int i0 = it * kTile, ni = min(kTile, cs - i0);
  const int n_inter = l > 0 ? 4 * nh : 0;
  const int per_tile = 4 + 2 * nh;
  const int n_units = n_inter + (it + 1) * per_tile;
  if (tid == 0) {
    for (int s = 0; s < U; ++s) {
      mbar_init(s_bar + 8 * s, 128);
      mbar_init(s_bar + 8 * (U + s), 128);
    }
    mbar_init(c_bar, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer ----
    const int pt = tid - 128;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      copy_kmajor(base + ch * kUnit, cm + (t0 + i0) * ds, ds, ni, 32 * ch,
                  ds, vec, pt, cm);
    {  // la_i of the pair [kHG][64]
      const int hh = pt / kTile, r = pt % kTile;
      const bool in = hh < nh && r < ni;
      hopper::cp_async4(base + L3::kLaI + 4 * pt,
                in ? la + (t0 + i0 + r) * H + h0 + hh : la, in);
    }
    spa::cp_async_commit();
    auto issue = [&](int n) {
      if (n < n_units) {
        const int slot = n % U;
        if (n >= U) mbar_wait(s_bar + 8 * (U + slot), ((n / U) - 1) & 1);
        const uint32_t u = base + L3::kRing + slot * kUnit;
        if (n < n_inter) {  // s_before's s-chunk n % 4: hi, then lo
          const float* st =
              ws + ((size_t)(bb * L + l) * H + h0 + n / 4) * (2 * kSlot);
          copy_kmajor(u, st, kDS, kHD, 32 * (n % 4), kDS, true, pt, ws);
          copy_kmajor(u + kChunk, st + kSlot, kDS, kHD, 32 * (n % 4), kDS,
                      true, pt, ws);
        } else {
          const int k = n - n_inter, r = k % per_tile;
          const int j0 = (k / per_tile) * kTile, nj = min(kTile, cs - j0);
          if (r < 4) {  // B_J's s-chunk r
            copy_kmajor(u, bm + (t0 + j0) * ds, ds, nj, 32 * r, ds, vec, pt,
                        bm);
          } else {  // X_J's half q of head h, raw; la_J, then dt_J
            const int q = (r - 4) % 2, h = h0 + (r - 4) / 2;
            copy_raw(u + kChunk,
                     x + (t0 + j0 + 32 * q) * x_ld + (size_t)h * hd, x_ld,
                     nj - 32 * q, 0, hd, vec, pt, x);
            const int rr = pt % kTile;
            const bool in = rr < nj;
            const float* src = pt < kTile ? la : dt;
            hopper::cp_async4(base + L3::kSideOff + slot * kSide + 4 * pt,
                      in ? src + (t0 + j0 + rr) * H + h : src, in);
          }
        }
      }
      spa::cp_async_commit();
    };
    for (int n = 0; n < kLead3; ++n) issue(n);
    spa::cp_async_wait<kLead3>();  // C_I and la_i
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) split_kmajor(sm + ch * kUnit, pt);
    fence_proxy_async();
    mbar_arrive(c_bar);
    for (int m = 0; m < n_units; ++m) {
      issue(m + kLead3);
      spa::cp_async_wait<kLead3>();  // this thread's copies of unit m
      const int slot = m % U;
      unsigned char* unit = sm + L3::kRing + slot * kUnit;
      if (m >= n_inter) {
        if ((m - n_inter) % per_tile < 4)
          split_kmajor(unit, pt);
        else
          transpose_split<false>(unit, nullptr, 0.f, 0, pt);
      }
      fence_proxy_async();
      mbar_arrive(s_bar + 8 * slot);
    }
    spa::cp_async_wait<0>();
    return;
  }

  // ---- consumer ----
  // accumulator index 4j + e: row 16 warp + g + 8 (e >> 1), column 8j + 2t
  // + (e & 1); A-fragment register r of the 8-column step K: row g + 8 (r &
  // 1), permuted position t + 4 (r >> 1), which holds column 2t + (r >> 1):
  // accumulator 4K + 2 (r & 1) + (r >> 1)
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp + g;
  auto wait_full = [&](int n) {
    mbar_wait(s_bar + 8 * (n % U), (n / U) & 1);
  };
  auto release = [&](int n) { mbar_arrive(s_bar + 8 * (U + n % U)); };
  auto unit_at = [&](int n) { return base + L3::kRing + (n % U) * kUnit; };
  float yacc[kHG][32], gacc[32], p[2][32];
  uint32_t m_hi[4][4], m_lo[4][4];
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[hh][i] = 0.f;
  // dst = the sum over C_I's four s-chunks times units n0 .. n0 + 3, each
  // chunk from a fresh accumulator, added in s order in f32 (two in flight)
  auto chain4 = [&](float (&dst)[32], int n0) {
    wait_full(n0);
    mma_chunk(dst, base, unit_at(n0), true);
    wgmma_commit();
    wait_full(n0 + 1);
    mma_chunk(p[0], base + kUnit, unit_at(n0 + 1), true);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(dst);
    release(n0);
    wait_full(n0 + 2);
    mma_chunk(p[1], base + 2 * kUnit, unit_at(n0 + 2), true);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(p[0]);
    add32(dst, p[0]);
    release(n0 + 1);
    wait_full(n0 + 3);
    mma_chunk(p[0], base + 3 * kUnit, unit_at(n0 + 3), true);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(p[1]);
    add32(dst, p[1]);
    release(n0 + 2);
    wgmma_wait<0>();
    reg_fence(p[0]);
    add32(dst, p[0]);
    release(n0 + 3);
  };

  mbar_wait(c_bar, 0);
  if (l > 0) {
    // y = exp(la_i) (C_I s_before^T), s_before K-major
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= nh) continue;
      chain4(yacc[hh], 4 * hh);
      const float e0 = expf(s_lai[hh * kTile + row0]);
      const float e1 = expf(s_lai[hh * kTile + row0 + 8]);
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[hh][i] *= (i >> 1) & 1 ? e1 : e0;
    }
  }
  for (int jt = 0; jt <= it; ++jt) {
    const int n0 = n_inter + jt * per_tile;
    const bool diag = jt == it;
    chain4(gacc, n0);  // G = C_I B_J^T
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= nh) continue;
      const float lai[2] = {s_lai[hh * kTile + row0],
                            s_lai[hh * kTile + row0 + 8]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 4 + 2 * hh + q;
        wait_full(n);
        const float* lj = reinterpret_cast<const float*>(
            sm + L3::kSideOff + (n % U) * kSide);
        const float* dj = lj + kTile;
        // M of the half's 32 columns in the A-fragment layout, hi and lo
        if (diag) {
          // exp(la_i - la_j) per element, for j <= i of the chunk's rows
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int K = 4 * q + kk, rr = r & 1, cc = r >> 1;
              const int row = row0 + 8 * rr, col = 8 * K + 2 * t + cc;
              const float m =
                  row < ni && col <= row
                      ? (gacc[4 * K + 2 * rr + cc] * expf(lai[rr] - lj[col])) *
                            dj[col]
                      : 0.f;
              const float hi = tf32_rna(m);
              m_hi[kk][r] = __float_as_uint(hi);
              m_lo[kk][r] = __float_as_uint(tf32_rna(m - hi));
            }
        } else {
          // a full j-tile below the diagonal: exp(la_i - la_j) dt_j = u_i v_j
          // about la_ref = la of the tile's last row (both exponents <= 0)
          const float ref = lj[kTile - 1];
          const float u[2] = {row0 < ni ? expf(lai[0] - ref) : 0.f,
                              row0 + 8 < ni ? expf(lai[1] - ref) : 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int K = 4 * q + kk, col = 8 * K + 2 * t + cc;
              const float v = expf(ref - lj[col]) * dj[col];
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const float m = (gacc[4 * K + 2 * rr + cc] * u[rr]) * v;
                const float hi = tf32_rna(m);
                m_hi[kk][rr + 2 * cc] = __float_as_uint(hi);
                m_lo[kk][rr + 2 * cc] = __float_as_uint(tf32_rna(m - hi));
              }
            }
        }
        // y += M X_J over the half's 32 rows j, from a fresh accumulator
#pragma unroll
        for (int i = 0; i < 32; ++i) p[0][i] = 0.f;
        reg_fence(p[0]);
        reg_fence(m_hi);
        reg_fence(m_lo);
        wgmma_fence();
        const uint32_t b = unit_at(n);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t b_hi = sw128_desc(b + kk * 32, 16, 1024);
          const uint64_t b_lo = sw128_desc(b + kChunk + kk * 32, 16, 1024);
          wgmma_tf32_rs_n64(p[0], m_hi[kk], b_hi);
          wgmma_tf32_rs_n64(p[0], m_hi[kk], b_lo);
          wgmma_tf32_rs_n64(p[0], m_lo[kk], b_hi);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(p[0]);
        add32(yacc[hh], p[0]);
        release(n);
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
      float* yr = y + ((t0 + i0 + row) * H + h0 + hh) * hd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = yacc[hh][4 * j + 2 * half];
        const float v1 = yacc[hh][4 * j + 2 * half + 1];
        if (col + 1 < hd && hd % 2 == 0) {
          *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
        } else {
          if (col < hd) yr[col] = v0;
          if (col + 1 < hd) yr[col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace tf

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
    ssd_chunk_pass<false><<<B * H * (kSlot / 8 / kWG), kWG, 0, s>>>(
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
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
                   hd % 4 == 0 && ds % 4 == 0;
  cudaError_t err;
  if (L > 1) {
    err = cudaFuncSetAttribute(tf::ssd_chunk_states_tf32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tf::L1::kBytes);
    if (err != cudaSuccess) return (int)err;
    tf::ssd_chunk_states_tf32<<<dim3(n_hg, L - 1, B), tf::kThreads1,
                                tf::L1::kBytes, s>>>(x, dt, la, b, ws, T_len,
                                                     H, hd, ds, cs, L, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_chunk_pass<true><<<B * H * (kSlot / 8 / kWG), kWG, 0, s>>>(
        la, ws, B, T_len, H, cs, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(tf::ssd_chunk_outputs_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tf::L3::kBytes);
  if (err != cudaSuccess) return (int)err;
  tf::ssd_chunk_outputs_tf32<<<dim3(n_it * n_hg, L, B), tf::kThreads3,
                               tf::L3::kBytes, s>>>(
      x, dt, la, b, c, ws, y, T_len, H, hd, ds, cs, L, n_hg, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, T, H, hd]; dt, la [B, T, H] f32; b, c [B, T, ds]; all
// contiguous; x, b, c, y one dtype (code); hd <= 64, ds <= 128, T a
// multiple of the chunk cs.  ws: the f32 workspace of the chunk states,
// [B, T / cs, H, 64, 128] for bf16 and [B, T / cs, H, 2, 64, 128] for f32
// (s_before as a TF32 pair), allocated by the caller; unused (may be null)
// when T == cs.  Launches three kernels on the stream (one when T == cs).
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
