// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, elementwise over
// channels, with an f32 carry from h_{-1} = 0 and the output in a's dtype.
//
// Replaces: src/repro/kernels/rglru_scan.py:rglru_scan (_rglru_kernel), a
//   grid over (channel blocks, sequence chunks) whose sequential chunk axis
//   carries h in VMEM scratch, so the sequence streams through once.
// Semantics, term for term: every step rounds a_t * h to f32, then adds b_t
//   and rounds again (no fused multiply-add), as the plain version does.
//   The chunked schedule below reassociates the carry at chunk boundaries,
//   so the kernel agrees with the sequential recurrence to f32 rounding, not
//   bit for bit (the first chunk is bit for bit).
// Bound on the H100: bytes.  At the main path's a, b [2, 16384, 4096] bf16
//   a call must read 268 MB twice and write 268 MB: 0.24 ms at 3.35 TB/s,
//   against 0.27 GFLOP.
// Design: one thread walking all of T for its channel gives B * d = 8192
//   threads, two warps an SM: far too few loads in flight to stream the
//   sequence.  Three passes over chunks of kChunk steps instead, each thread
//   owning V channels (one 16-byte vector) of one chunk of one batch row:
//   1. summary: the chunk's product of a and its end state from h = 0;
//   2. carry: one thread per channel walks the chunks in order and writes
//      each chunk's start state (f32, [B, n_chunks, d]);
//   3. rewrite: each chunk runs the recurrence again from its start state
//      and writes h.
//   Passes 1 and 3 put B * n_chunks * d / V threads in flight (about one
//   full wave of the card at the main path's shape); the loads of a step do
//   not depend on h, so an unrolled loop keeps several rows in flight.
//   Passes 1 and 3 both read a and b: 5/3 of the single-pass bytes, about
//   0.40 ms at the main path's shape.  The carry pass moves 3 * B *
//   n_chunks * d * 4 bytes (25 MB there).
#include "common.cuh"

namespace {

constexpr int kChunk = 64;     // time steps per chunk
constexpr int kThreads = 128;

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = spa::to_f32(p[0]);
  } else {
    static_assert(sizeof(T) * V == 16, "one 16-byte vector");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = spa::to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = spa::from_f32<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = spa::from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// pass 1: prod[b, j, c] = prod_t a_t and last[b, j, c] = h at the chunk's
// end from h = 0, over chunk j
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) chunk_summary(
    const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ prod,
    float* __restrict__ last, int T_len, int d, int n_chunks) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= d) return;
  const int j = blockIdx.y, bb = blockIdx.z;
  const int t0 = j * kChunk, t1 = min(T_len, t0 + kChunk);
  float p[V], h[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    p[i] = 1.f;
    h[i] = 0.f;
  }
  const size_t row0 = (size_t)bb * T_len;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    float av[V], bv[V];
    load_vec<T, V>(a + (row0 + t) * d + c, av);
    load_vec<T, V>(b + (row0 + t) * d + c, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[i] = __fmul_rn(av[i], p[i]);
      h[i] = __fadd_rn(__fmul_rn(av[i], h[i]), bv[i]);
    }
  }
  const size_t o = ((size_t)bb * n_chunks + j) * d + c;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    prod[o + i] = p[i];
    last[o + i] = h[i];
  }
}

// pass 2: start[b, j, c] = h entering chunk j (0 for the first chunk)
__global__ void __launch_bounds__(kThreads) chunk_carry(
    const float* __restrict__ prod, const float* __restrict__ last,
    float* __restrict__ start, int d, int n_chunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const size_t base = (size_t)blockIdx.y * n_chunks * d + c;
  float s = 0.f;
#pragma unroll 16
  for (int j = 0; j < n_chunks; ++j) {
    const size_t o = base + (size_t)j * d;
    const float p = prod[o], e = last[o];
    start[o] = s;
    s = __fadd_rn(__fmul_rn(p, s), e);
  }
}

// pass 3: run each chunk again from its start state and write h
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) chunk_rewrite(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ start, T* __restrict__ out, int T_len, int d,
    int n_chunks) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= d) return;
  const int j = blockIdx.y, bb = blockIdx.z;
  const int t0 = j * kChunk, t1 = min(T_len, t0 + kChunk);
  const size_t so = ((size_t)bb * n_chunks + j) * d + c;
  float h[V];
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = start[so + i];
  const size_t row0 = (size_t)bb * T_len;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    float av[V], bv[V];
    const size_t off = (row0 + t) * d + c;
    load_vec<T, V>(a + off, av);
    load_vec<T, V>(b + off, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) h[i] = __fadd_rn(__fmul_rn(av[i], h[i]), bv[i]);
    store_vec<T, V>(out + off, h);
  }
}

template <typename T, int V>
int launch(const void* a, const void* b, float* prod, float* last,
           float* start, void* out, int B, int T_len, int d, int n_chunks,
           cudaStream_t s) {
  const dim3 grid((d / V + kThreads - 1) / kThreads, n_chunks, B);
  chunk_summary<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), prod, last, T_len,
      d, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry<<<dim3((d + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
      prod, last, start, d, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_rewrite<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), start,
      static_cast<T*>(out), T_len, d, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spa_rglru_chunk() { return kChunk; }

// a, b, out [B, T, d] contiguous, all f32 or all bf16 (dtype code);
// scratch: three f32 buffers of [B, n_chunks, d], n_chunks =
// ceil(T / spa_rglru_chunk()).
extern "C" int spa_rglru_scan(const void* a, const void* b, void* out,
                              void* prod, void* last, void* start, int B,
                              int T_len, int d, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  float* p = static_cast<float*>(prod);
  float* l = static_cast<float*>(last);
  float* st = static_cast<float*>(start);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (dtype == spa::kF32) {
    return aligned && d % 4 == 0
               ? launch<float, 4>(a, b, p, l, st, out, B, T_len, d, n_chunks, s)
               : launch<float, 1>(a, b, p, l, st, out, B, T_len, d, n_chunks, s);
  }
  if (dtype == spa::kBF16) {
    return aligned && d % 8 == 0
               ? launch<__nv_bfloat16, 8>(a, b, p, l, st, out, B, T_len, d,
                                          n_chunks, s)
               : launch<__nv_bfloat16, 1>(a, b, p, l, st, out, B, T_len, d,
                                          n_chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}
