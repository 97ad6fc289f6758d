// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, elementwise over
// channels, with an f32 carry from h_{-1} = 0 and the output in a's dtype.
//
// Replaces: src/repro/kernels/rglru_scan.py:rglru_scan (_rglru_kernel), a
//   grid over (channel blocks, sequence chunks) whose sequential chunk axis
//   carries h in VMEM scratch, so the sequence streams through once.
// Semantics, term for term: every step rounds a_t * h to f32, then adds b_t
//   and rounds again (no fused multiply-add), as the plain version does.
//   Across chunks of kChunk steps the carry composes affine pairs: chunk j
//   has P_j = prod a (in step order) and E_j = its end state from h = 0,
//   and enters with S_0 = 0, S_{j+1} = (P_j * S_j) + E_j, each rounded.
//   That reassociates the carry at chunk boundaries, so the kernel agrees
//   with the sequential recurrence to f32 rounding, not bit for bit (the
//   first chunk is bit for bit); S_j does not depend on the schedule, so
//   every run gives the same bits.
// Bound on the H100: bytes.  At the main path's a, b [2, 16384, 4096] bf16
//   a call must read a and b (537 MB) and write h (268 MB): 0.24 ms at
//   3.35 TB/s, against 0.27 GFLOP.
// Design: one pass with a decoupled look-back.  A CTA takes a tile of
//   kChunk steps x kCW channels (256 bytes of a row: 128 bf16 or 64 f32
//   channels) of one batch row, in the order of an atomic tile counter,
//   time chunk slowest, so every tile of an earlier chunk has started
//   (and is resident, or done) before it.  Its a and b tiles (32 KB: six
//   CTAs an SM) come into shared memory once, by the bulk-copy engine (a
//   256-byte row of a and of b a thread, every row in flight at once; a
//   plain copy where rows are not 16-byte aligned).  Two data warps form
//   (P_j, E_j) of two (bf16) or one (f32) channels a thread and publish
//   them at once.  Meanwhile a look-back warp reads the state of the 32
//   nearest earlier chunks of the tile's channels in one step and finds
//   the nearest one whose S is published, waiting only while a nearer one
//   has published nothing: the wait for predecessors overlaps the tile's
//   own copies.  Each data thread then walks forward from that S through
//   the published (P, E) of the chunks between (eight chunks' loads in
//   flight at once, from L2) as the formula above, publishes S_{j+1}, runs
//   the recurrence again from S_j out of shared memory, writes h over a
//   there and stores the rows in 16-byte units: a and b are read once and
//   h written once.
//   Publishing costs no fence: each channel's (P, E) is one 64-bit word
//   and its S one 32-bit word, written once with a single-copy-atomic
//   store over a workspace that a cudaMemsetAsync on the stream fills with
//   0xFF bytes first.  The all-ones pattern is a NaN that f32 arithmetic
//   never produces (its NaNs are canonical), so a reader spins until its
//   word is not all ones and then holds the published value, with no flag
//   to order against.  A release store would wait for the write to be
//   acknowledged, which under the stream's load takes microseconds, and
//   every later tile's look-back would wait for that.  The workspace (P,
//   E and S: 12 bytes a channel and chunk, 25 MB at the main shape) and
//   its fill (3% of the call's bytes there) are the price.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kChunk = 64;     // time steps of a tile
constexpr int kDataThreads = 64;
constexpr int kThreads = kDataThreads + 32;  // + the look-back warp
constexpr int kLookWarp = kDataThreads / 32;
constexpr int kTileRow = 256;  // bytes of a row of a tile
constexpr int kLook = 32;      // earlier chunks the look-back reads at once
constexpr int kWalk = 8;       // earlier chunks whose carries load together
constexpr uint32_t kUnset = 0xFFFFFFFFu;  // a word not yet published

__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint64_t ld_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_word(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_word(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// A published word: spin while it is unset.  A word that never comes (a
// lost tile) traps after about 8 s of SM clocks instead of hanging the
// card.
template <typename W>
__device__ __forceinline__ W await(const W* p) {
  W v = ld_word(p);
  if ((uint32_t)v != kUnset) return v;
  const long long t0 = clock64();
  while ((uint32_t)(v = ld_word(p)) == kUnset)
    if (clock64() - t0 > (1ll << 34)) __trap();
  return v;
}

__device__ __forceinline__ uint64_t pack(float p, float e) {
  return (uint64_t)__float_as_uint(p) | ((uint64_t)__float_as_uint(e) << 32);
}

// V channels of one step from a shared tile row, and h of them to out.
__device__ __forceinline__ void get(const float* s, float (&f)[1]) {
  f[0] = s[0];
}
__device__ __forceinline__ void get(const __nv_bfloat16* s, float (&f)[2]) {
  const float2 v = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(s));
  f[0] = v.x;
  f[1] = v.y;
}
__device__ __forceinline__ void put(float* p, const float (&f)[1], bool,
                                    bool) {
  __stcs(p, f[0]);
}
// pair: both channels exist and p is 4-byte aligned; else p[0] alone,
// and p[1] where `second`
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&f)[2],
                                    bool pair, bool second) {
  if (pair) {
    __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
    __stcs(reinterpret_cast<unsigned*>(p), *reinterpret_cast<unsigned*>(&v));
  } else {
    p[0] = __float2bfloat16_rn(f[0]);
    if (second) p[1] = __float2bfloat16_rn(f[1]);
  }
}

// h of V channels into a shared tile row, in the tile's type.
__device__ __forceinline__ void put_shared(float* p, const float (&f)[1]) {
  p[0] = f[0];
}
__device__ __forceinline__ void put_shared(__nv_bfloat16* p,
                                           const float (&f)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
}

// The workspace of a call: the tile counter (16 bytes, zeroed), then
// (P, E) words [n_tiles][kCW] and S words [n_tiles][kCW] (all ones).
struct Workspace {
  int* counter;
  uint64_t* agg;
  uint32_t* incl;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) rglru_lookback(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    Workspace ws, int T_len, int d, int n_slices, int n_cblk, bool bulk,
    bool rows16) {
  constexpr int kCW = kTileRow / sizeof(T);  // channels of a tile
  extern __shared__ __align__(128) unsigned char tile_smem[];
  T* sa = reinterpret_cast<T*>(tile_smem);   // [kChunk][kCW]
  T* sb = sa + kChunk * kCW;
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_tile, s_from;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t bar_a = hopper::smem_u32(&bar);
  if (tid == 0) {
    s_tile = atomicAdd(ws.counter, 1);
    hopper::mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tile = s_tile;
  const int j = tile / n_slices, slice = tile - j * n_slices;
  const int bb = slice / n_cblk;
  const int c0 = (slice - bb * n_cblk) * kCW;
  const int nc = min(kCW, d - c0);  // channels of this tile
  const int t0 = j * kChunk, nt = min(kChunk, T_len - t0);
  const size_t row = (size_t)bb * T_len + t0;

  if (warp == kLookWarp) {
    // ---- the nearest earlier chunk whose S is published (-1: none,
    // start from S_0 = 0), waiting while a nearer one has published
    // nothing; a tile's first channel stands for the tile (the data
    // threads wait for any other channel that lags) ----
    if (j == 0) return;
    int k0 = tile;
    const long long t_start = clock64();
    for (;;) {
      const int k = k0 - (lane + 1) * n_slices;
      const bool s_set =
          k < 0 || ld_word(ws.incl + (size_t)k * kCW) != kUnset;
      const bool p_set =
          s_set || (uint32_t)ld_word(ws.agg + (size_t)k * kCW) != kUnset;
      const unsigned done = __ballot_sync(0xffffffffu, s_set);
      const unsigned none = __ballot_sync(0xffffffffu, !p_set);
      const unsigned upto = done ? (done & (0u - done)) - 1u : ~0u;
      if (none & upto) {  // a nearer chunk has not published yet
        if (clock64() - t_start > (1ll << 34)) __trap();
        continue;
      }
      if (done) {
        if (lane == 0) s_from = k0 - __ffs(done) * n_slices;
        break;
      }
      k0 -= kLook * n_slices;
    }
    asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    return;
  }

  // ---- data warps: the tile into shared memory ----
  if (bulk) {
    if (tid == 0)
      hopper::mbar_expect_tx(bar_a, 2 * nt * nc * (uint32_t)sizeof(T));
    if (tid < nt) {  // row tid of a and of b
      const size_t off = (row + tid) * d + c0;
      hopper::bulk_load(hopper::smem_u32(sa + tid * kCW), a + off,
                        nc * sizeof(T), bar_a);
      hopper::bulk_load(hopper::smem_u32(sb + tid * kCW), b + off,
                        nc * sizeof(T), bar_a);
    }
    hopper::mbar_wait(bar_a, 0);
  } else {
    for (int e = tid; e < nt * kCW; e += kDataThreads) {
      const int i = e / kCW, c = e - i * kCW;
      if (c < nc) {
        sa[e] = a[(row + i) * d + c0 + c];
        sb[e] = b[(row + i) * d + c0 + c];
      }
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(kDataThreads) : "memory");
  }

  // (P_j, E_j): the chunk's product of a and its end state from h = 0
  const int cl = tid * V;  // this thread's channels in the tile
  float p[V], e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    p[v] = 1.f;
    e[v] = 0.f;
  }
#pragma unroll 8
  for (int i = 0; i < nt; ++i) {
    float af[V], bf[V];
    get(sa + i * kCW + cl, af);
    get(sb + i * kCW + cl, bf);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = __fmul_rn(af[v], p[v]);
      e[v] = __fadd_rn(__fmul_rn(af[v], e[v]), bf[v]);
    }
  }
  const size_t w = (size_t)tile * kCW + cl;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s[v] = 0.f;
    if (j == 0)
      st_word(ws.incl + w + v,
              __float_as_uint(__fadd_rn(__fmul_rn(p[v], 0.f), e[v])));
    else
      st_word(ws.agg + w + v, pack(p[v], e[v]));
  }
  if (j > 0) {
    // S_j: from the published S of chunk m, through the (P, E) of the
    // chunks between, kWalk chunks' loads in flight together
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    const int m = s_from;
    int k = m >= 0 ? m : slice;  // S_{k + 1} from S_k
    if (m >= 0) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        s[v] = __uint_as_float(await(ws.incl + (size_t)m * kCW + cl + v));
      k += n_slices;
    }
    for (; k < tile; k += kWalk * n_slices) {
      uint64_t pe[kWalk][V];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const bool in = k + u * n_slices < tile;
        const size_t o = (size_t)(k + u * n_slices) * kCW + cl;
#pragma unroll
        for (int v = 0; v < V; ++v)
          pe[u][v] = in ? ld_word(ws.agg + o + v) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u)
        if (k + u * n_slices < tile)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const size_t o = (size_t)(k + u * n_slices) * kCW + cl + v;
            const uint64_t x =
                (uint32_t)pe[u][v] != kUnset ? pe[u][v] : await(ws.agg + o);
            s[v] = __fadd_rn(__fmul_rn(__uint_as_float((uint32_t)x), s[v]),
                             __uint_as_float((uint32_t)(x >> 32)));
          }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      st_word(ws.incl + w + v,
              __float_as_uint(__fadd_rn(__fmul_rn(p[v], s[v]), e[v])));
  }

  // the recurrence again from S_j, out of shared memory.  Where rows are
  // 16-byte aligned, h goes over a in place and leaves in 16-byte stores
  // once the tile is done, four times fewer than a word a step a thread.
  const int c = c0 + cl;
  const bool second = c + 1 < d;
  const bool pair = V == 2 && second && d % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll 8
  for (int i = 0; i < nt; ++i) {
    float af[V], bf[V];
    get(sa + i * kCW + cl, af);
    get(sb + i * kCW + cl, bf);
#pragma unroll
    for (int v = 0; v < V; ++v)
      s[v] = __fadd_rn(__fmul_rn(af[v], s[v]), bf[v]);
    if (rows16)
      put_shared(sa + i * kCW + cl, s);
    else if (c < d)
      put(out + (row + i) * d + c, s, pair, second);
  }
  if (rows16) {
    asm volatile("bar.sync 2, %0;\n" ::"n"(kDataThreads) : "memory");
    const int units = nc * (int)sizeof(T) / 16;  // 16-byte units of a row
    for (int x = tid; x < nt * units; x += kDataThreads) {
      const int i = x / units, u = x - i * units;
      __stcs(reinterpret_cast<uint4*>(out + (row + i) * d + c0) + u,
             reinterpret_cast<const uint4*>(sa + i * kCW)[u]);
    }
  }
}

long long tiles(int B, int T_len, int d, int cw) {
  return (long long)((T_len + kChunk - 1) / kChunk) * B *
         ((d + cw - 1) / cw);
}

constexpr size_t kCounterBytes = 16;

template <typename T, int V>
int launch(const void* a, const void* b, void* out, void* ws, int B,
           int T_len, int d, cudaStream_t s) {
  constexpr int kCW = kTileRow / sizeof(T);
  constexpr int kSmem = 2 * kChunk * kTileRow;
  const int n_cblk = (d + kCW - 1) / kCW;
  const long long n_tiles = tiles(B, T_len, d, kCW);
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(ws);
  const size_t n = (size_t)n_tiles * kCW;
  uint64_t* agg = reinterpret_cast<uint64_t*>(base + kCounterBytes);
  Workspace w{reinterpret_cast<int*>(base), agg,
              reinterpret_cast<uint32_t*>(agg + n)};
  // rows by the bulk-copy engine, and h by 16-byte stores: 16-byte
  // aligned rows and row pieces
  const bool row_ok = (d * sizeof(T)) % 16 == 0;
  const bool bulk = ((reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b)) & 15) == 0 && row_ok;
  const bool rows16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && row_ok;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_lookback<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(base, 0, kCounterBytes, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(agg, 0xFF, n * (sizeof(uint64_t) + sizeof(uint32_t)),
                        s);
  if (err != cudaSuccess) return (int)err;
  rglru_lookback<T, V><<<(unsigned)n_tiles, kThreads, kSmem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      w, T_len, d, B * n_cblk, n_cblk, bulk, rows16);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the workspace spa_rglru_scan needs for a, b [B, T, d] (the
// larger of its two channel widths).
extern "C" long long spa_rglru_workspace_bytes(int B, int T_len, int d) {
  if (B <= 0 || T_len <= 0 || d <= 0) return 0;
  const long long f32 = tiles(B, T_len, d, kTileRow / 4) * (kTileRow / 4);
  const long long bf16 = tiles(B, T_len, d, kTileRow / 2) * (kTileRow / 2);
  return (long long)kCounterBytes + 12 * (f32 > bf16 ? f32 : bf16);
}

// a, b, out [B, T, d] contiguous, all f32 or all bf16 (dtype code); ws a
// device buffer of spa_rglru_workspace_bytes(B, T, d) bytes, used by one
// call at a time.
extern "C" int spa_rglru_scan(const void* a, const void* b, void* out,
                              void* ws, int B, int T_len, int d, int dtype,
                              void* stream) {
  if (B <= 0 || T_len <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spa::kF32)
    return launch<float, 1>(a, b, out, ws, B, T_len, d, s);
  if (dtype == spa::kBF16)
    return launch<__nv_bfloat16, 2>(a, b, out, ws, B, T_len, d, s);
  return (int)cudaErrorInvalidValue;
}
