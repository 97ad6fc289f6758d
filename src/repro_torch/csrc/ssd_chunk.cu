// The Mamba-2 SSD chunked scan: per batch row and head, over chunks of cs
// steps in order, with the state S [hd, ds] in f32 from zero:
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
//   Here one block owns one (batch row, head) and walks its chunks in a loop.
// Semantics: as the Pallas kernel and the JAX model's ssd_scan, up to the
//   order of f32 sums.  The causal mask is applied before the exponential:
//   exp(la_i - la_j) is formed only for j <= i (for j > i it can overflow),
//   so no inf ever exists, where the reference masks the inf afterwards.
// Bound on the H100: bytes.  At Mamba2-370m's decode shape (x [4, 4096, 32,
//   64] bf16, ds 128, chunk 256) a call reads x, b, c, dt, la once and
//   writes y: 147 MB, 0.044 ms at 3.35 TB/s, against 35.5 GFLOP of products
//   (C B^T once per batch row and chunk).
// Design (first version, right before fast): f32 products on the CUDA
//   cores, never on the tensor cores (TF32 would lose the f32 parity).  A
//   chunk is cut into tiles of 64 rows, so the masked [cs, cs] matrix is
//   never held whole: for each i-tile, y_inter from S, then for each j-tile
//   at or before it, G = C_I B_J^T in registers, the masked M tile in shared
//   memory and y += M X_J; after the chunk's outputs, S is updated from the
//   chunk's j-tiles.  256 threads hold 4 x 4 (4 x 8 for S) output elements
//   each, reading shared memory with odd row strides (no bank conflicts).
//   C B^T is recomputed per head (32x the necessary work) and B * H = 128
//   blocks fill 128 of 132 SMs at one block each: both are the redesign's
//   work (tensor cores for C B^T, chunk-parallel states).
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // chunk rows per i- or j-tile
constexpr int kHD = 64;        // largest head_dim
constexpr int kDS = 128;       // largest d_state
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdS = kDS + 1;  // row strides of the shared tiles (odd)
constexpr int kLdX = kHD + 1;
constexpr int kLdM = kTile + 1;
constexpr int kSmemFloats = kHD * kLdS + 2 * kTile * kLdS + kTile * kLdX +
                            kTile * kLdM + 4 * kTile;
constexpr int kSmemBytes = kSmemFloats * 4;

// rows x cols tile of a row-major source (row stride ld_src elements) into
// shared f32 (row stride ld), zero outside rows_valid x cols_valid
template <typename T, int kCols>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          size_t ld_src, int rows_valid,
                                          int cols_valid) {
  for (int idx = threadIdx.x; idx < kTile * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    float v = 0.f;
    if (r < rows_valid && c < cols_valid)
      v = spa::to_f32(src[(size_t)r * ld_src + c]);
    dst[r * ld + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const T* __restrict__ bm,
    const T* __restrict__ cm, T* __restrict__ y, int T_len, int H, int hd,
    int ds, int cs) {
  extern __shared__ float smem[];
  float* sS = smem;                   // [hd][ds]   the state
  float* sC = sS + kHD * kLdS;        // [64][ds]   C of the i-tile
  float* sB = sC + kTile * kLdS;      // [64][ds]   B of the j-tile
  float* sX = sB + kTile * kLdS;      // [64][hd]   X of the j-tile
  float* sM = sX + kTile * kLdX;      // [64][64]   masked M tile
  float* sLaI = sM + kTile * kLdM;    // la of the i-tile's rows
  float* sLaJ = sLaI + kTile;         // la of the j-tile's rows
  float* sDtJ = sLaJ + kTile;         // dt of the j-tile's rows
  float* sW = sDtJ + kTile;           // exp(la_end - la_j) dt_j

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bb = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row0 = (size_t)bb * T_len;
  const size_t x_ld = (size_t)H * hd;
  const int n_chunks = T_len / cs;
  const int n_tiles = (cs + kTile - 1) / kTile;

  for (int i = tid; i < kHD * kLdS; i += kThreads) sS[i] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t t0 = row0 + (size_t)ch * cs;   // first row of the chunk
    const float la_end = la[(t0 + cs - 1) * H + h];

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile, ni = min(kTile, cs - i0);
      __syncthreads();   // earlier readers of sC / sLaI, writers of sS done
      load_tile<T, kDS>(sC, kLdS, cm + (t0 + i0) * ds, ds, ni, ds);
      if (tid < kTile)
        sLaI[tid] = tid < ni ? la[(t0 + i0 + tid) * H + h] : 0.f;
      __syncthreads();

      // y_inter = C_I S^T: rows i = ty + 16 r, columns d = tx + 16 c
      float inter[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < ds; ++s) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * kLdS + s];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = sS[(tx + 16 * c) * kLdS + s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] += cv[r] * sv[c];
      }

      float acc[4][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile, nj = min(kTile, cs - j0);
        __syncthreads();   // earlier readers of sB / sX / sM done
        load_tile<T, kDS>(sB, kLdS, bm + (t0 + j0) * ds, ds, nj, ds);
        load_tile<T, kHD>(sX, kLdX, x + (t0 + j0) * x_ld + (size_t)h * hd,
                          x_ld, nj, hd);
        if (tid < kTile) {
          const bool ok = tid < nj;
          sLaJ[tid] = ok ? la[(t0 + j0 + tid) * H + h] : 0.f;
          sDtJ[tid] = ok ? dt[(t0 + j0 + tid) * H + h] : 0.f;
        }
        __syncthreads();

        // G = C_I B_J^T: rows i = ty + 16 r, columns j = tx + 16 c
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
              m = (g[r][c] * expf(sLaI[il] - sLaJ[jl])) * sDtJ[jl];
            sM[il * kLdM + jl] = m;
          }
        }
        __syncthreads();

        // y_intra += M X_J: rows i = ty + 16 r, columns d = tx + 16 c
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
            for (int c = 0; c < 4; ++c) acc[r][c] += mv[r] * xv[c];
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = ty + 16 * r;
        if (il >= ni) continue;
        const float e = expf(sLaI[il]);
        T* yr = y + (t0 + i0 + il) * x_ld + (size_t)h * hd;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = tx + 16 * c;
          if (d < hd) yr[d] = spa::from_f32<T>(acc[r][c] + inter[r][c] * e);
        }
      }
    }

    // S' = exp(la_end) S + X^T (w o B): rows d = ty + 16 r, columns
    // s = tx + 16 c (c < 8); each thread owns its 32 elements of sS
    float upd[4][8] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kTile, nj = min(kTile, cs - j0);
      __syncthreads();   // earlier readers of sB / sX / sS done
      load_tile<T, kDS>(sB, kLdS, bm + (t0 + j0) * ds, ds, nj, ds);
      load_tile<T, kHD>(sX, kLdX, x + (t0 + j0) * x_ld + (size_t)h * hd,
                        x_ld, nj, hd);
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
    const float a_end = expf(la_end);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float* sp = sS + (ty + 16 * r) * kLdS + tx + 16 * c;
        *sp = a_end * *sp + upd[r][c];
      }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* la, const void* b,
           const void* c, void* y, int B, int T_len, int H, int hd, int ds,
           int cs, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<T><<<B * H, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(la), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), T_len, H, hd, ds, cs);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, T, H, hd]; dt, la [B, T, H] f32; b, c [B, T, ds]; all
// contiguous; x, b, c, y one dtype (code); hd <= 64, ds <= 128, T a
// multiple of the chunk cs.
extern "C" int spa_ssd_chunk_scan(const void* x, const void* dt,
                                  const void* la, const void* b,
                                  const void* c, void* y, int B, int T_len,
                                  int H, int hd, int ds, int cs, int dtype,
                                  void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || hd <= 0) return 0;
  if (hd > kHD || ds <= 0 || ds > kDS || cs <= 0 || T_len % cs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spa::kF32)
    return launch<float>(x, dt, la, b, c, y, B, T_len, H, hd, ds, cs, s);
  if (dtype == spa::kBF16)
    return launch<__nv_bfloat16>(x, dt, la, b, c, y, B, T_len, H, hd, ds, cs,
                                 s);
  return (int)cudaErrorInvalidValue;
}
