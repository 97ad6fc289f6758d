// In-place multi-buffer row commit: the rows [B, k, ...] of every buffer of
// one commit (K + V (+ scales), or H (+ scale) + proxy) are written at
// idx [B, k] into their [B, N, ...] cache buffers in one launch; indices
// outside [0, N) are dropped; any index order is correct; the result is a
// copy, bit for bit.
//
// Replaces: src/repro/kernels/scatter_update.py:scatter_update_multi (Pallas,
//   _scatter_multi_kernel), which walks index chunks and turns runs of 8
//   consecutive indices into one DMA.  That batching is a TPU transfer detail;
//   this kernel reproduces its result, not its scheme.
// Bound on the H100: bytes.  Every row is read once and written once: a K+V
//   commit of k=128 rows at B=4 (32 heads of 128, bf16) moves 2 x 8.4 MB =
//   16.8 MB, 5.0 us at 3.35 TB/s; H + proxy moves 8.65 MB; the hybrid's H +
//   proxy (B=2, k=4096) 138 MB, 41 us.  No arithmetic.  At the LLaDA shapes
//   a call is as short as a launch: a one-element kernel takes 5.4 us from
//   event to event (chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at
//   700 W), so latency, not bandwidth, sets those times.
// What held the first port back: one 128-thread block per (selected row,
//   batch row) first waited on a dependent load of its index, then copied
//   buffer after buffer, so a block waited for one buffer's row before it
//   loaded the next; a 512-byte row kept a quarter of its threads busy.
// Design: the host (kernels/scatter_update.py:plan_units, a pure function)
//   cuts every (batch row, selected row, buffer) copy into units of at most
//   kUnitMax bytes (a row's units of equal size, 16-byte multiples), numbers
//   them row by row and buffer by buffer within a row, and gives each CTA of
//   a grid of about four CTAs an SM an equal contiguous range of units, each
//   of its four warps a contiguous part of at most kWarpRows rows.  A warp
//   loads the indices of its rows once, one a lane in one coalesced load,
//   and reads them by shuffles.  It walks its units with a cursor that every
//   lane holds alike (one division at the start, then increments) and
//   copies them a step at a time: each lane loads its 16 bytes of up to
//   kSlots 512-byte words of consecutive units (several small rows, or two
//   4 KB units) before it stores any, so a 512-byte row is one word of a
//   warp and every buffer's rows are in flight at once.  Units whose
//   addresses, strides or width are not 16-byte multiples (a 2-byte f16
//   scale, a 10-byte row) take 4- or 1-byte moves by the whole warp in the
//   same launch, four a lane in flight.  The kernel uses no shared memory:
//   staging the indices there for the whole CTA behind a barrier made every
//   call slower on the card, even one with no row to copy.  Two other
//   development designs measured slower at the LLaDA shapes (PERF.md,
//   Findings): copying the 16-byte units by the bulk-copy engine
//   (cp.async.bulk into a shared stage and back out) was no faster than
//   the same split through registers, and a thread per 16-byte move spent
//   more time working out addresses than moving bytes.  The kernel sits at
//   the 128-register limit of four CTAs an SM: a field more in the cursor
//   spilled and slowed every call.
#include "common.cuh"

namespace {

constexpr int kMaxBufs = 8;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 32 * WARPS of kernels/scatter_update.py
constexpr int kUnitMax = 4096;         // UNIT_MAX
constexpr int kWarpRows = 32;          // WARP_ROWS: rows a warp's units may span
constexpr int kSlots = 16;             // 512-byte words a warp moves a step

struct Buf {
  char* dst;
  const char* src;
  long long row_bytes, dst_bstride, dst_rstride, src_bstride, src_rstride;
  int chunk;  // bytes of a unit (the row's last unit may be shorter)
  int first;  // the buffer's first unit within a row
  int vec;    // 16: its rows take 16-byte moves; else narrow moves
  int pad;
};

struct Plan {
  Buf buf[kMaxBufs];
  long long units;  // units of the call: rows x per_row
  long long upc;    // units per CTA
  int upw;          // units per warp
  int n, per_row, k, N;
};

__device__ __forceinline__ long long u_hi_of(const Plan& p, long long u_lo) {
  return min(u_lo + p.upc, p.units);
}

// A warp's position in its units and the unit there; every lane holds the
// same values, apart from its own 16 bytes of the unit (src, dst, skip).
struct Cursor {
  int m, cnt;  // units passed, units of the warp
  int rr;      // row, counted from the warp's first row
  int q, t;    // unit within the row, and its buffer
  int b, j;    // the row's batch row and selected row
  const char* src;  // 16-byte units: this lane's 16 bytes of the next word
  char* dst;
  int left;    // 16-byte units: 512-byte words not yet moved
  int skip;    // ... of which this lane has bytes while left > skip
  int bytes;
  bool narrow;  // a unit of 4- or 1-byte moves, not yet copied
};

__device__ __forceinline__ void load_unit(Cursor& c, const Plan& p,
                                          int rows_idx, int lane) {
  const Buf& bb = p.buf[c.t];
  const int lo = (c.q - bb.first) * bb.chunk;
  const int i = __shfl_sync(0xffffffffu, rows_idx, c.rr);
  c.left = 0;
  c.narrow = false;
  if (i < 0 || i >= p.N) return;  // dropped
  c.bytes = (int)min((long long)bb.chunk, bb.row_bytes - lo);
  c.src = bb.src + c.b * bb.src_bstride + c.j * bb.src_rstride + lo;
  c.dst = bb.dst + c.b * bb.dst_bstride + (long long)i * bb.dst_rstride + lo;
  if (bb.vec != 16) {
    c.narrow = true;
    return;
  }
  c.left = (c.bytes + 511) >> 9;
  const int mine = c.bytes > lane * 16 ? (c.bytes - lane * 16 + 511) >> 9 : 0;
  c.skip = c.left - mine;
  c.src += lane * 16;
  c.dst += lane * 16;
}

__device__ __forceinline__ void advance(Cursor& c, const Plan& p,
                                        int rows_idx, int lane) {
  c.left = 0;
  c.narrow = false;
  if (++c.m >= c.cnt) return;
  if (++c.q == p.per_row) {
    c.q = 0;
    c.t = 0;
    ++c.rr;
    if (++c.j == p.k) {
      c.j = 0;
      ++c.b;
    }
  }
  while (c.t + 1 < p.n && c.q >= p.buf[c.t + 1].first) ++c.t;
  load_unit(c, p, rows_idx, lane);
}

// A narrow unit, copied by the whole warp with four moves a lane in flight,
// loads before stores: 4-byte moves where the unit's addresses and width
// allow, else single bytes.
template <typename W>
__device__ __forceinline__ void copy_narrow(const Cursor& c, int lane) {
  constexpr int kV = sizeof(W);
  constexpr int kU = 4;
  for (int o = lane * kV; o < c.bytes; o += kU * 32 * kV) {
    W v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int oo = o + u * 32 * kV;
      if (oo < c.bytes) v[u] = *reinterpret_cast<const W*>(c.src + oo);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int oo = o + u * 32 * kV;
      if (oo < c.bytes) *reinterpret_cast<W*>(c.dst + oo) = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) scatter_kernel(
    const int* __restrict__ idx, const __grid_constant__ Plan p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long u_lo = (long long)blockIdx.x * p.upc;
  const long long w_lo = u_lo + (long long)warp * p.upw;
  Cursor c;
  c.m = 0;
  c.cnt = (int)max(0LL, min((long long)p.upw, u_hi_of(p, u_lo) - w_lo));
  if (c.cnt <= 0) return;
  // the indices of the warp's rows (at most 32), one a lane, by one
  // coalesced load
  const long long r_w = w_lo / p.per_row;
  const int rel = (int)(w_lo - r_w * p.per_row);
  const int nrows = (rel + c.cnt - 1) / p.per_row + 1;
  const int rows_idx = lane < nrows ? idx[r_w + lane] : -1;
  c.rr = 0;
  c.q = rel;
  c.t = 0;
  while (c.t + 1 < p.n && c.q >= p.buf[c.t + 1].first) ++c.t;
  c.b = (int)(r_w / p.k);
  c.j = (int)(r_w - (long long)c.b * p.k);
  load_unit(c, p, rows_idx, lane);

  while (c.m < c.cnt) {
    uint4 v[kSlots];
    char* dst[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      dst[s] = nullptr;
      // on to a unit with a 16-byte word left; stop at a narrow one
      while (c.left == 0 && !c.narrow && c.m < c.cnt)
        advance(c, p, rows_idx, lane);
      if (c.left > 0) {
        if (c.left > c.skip) {
          v[s] = *reinterpret_cast<const uint4*>(c.src);
          dst[s] = c.dst;
        }
        c.src += 512;
        c.dst += 512;
        --c.left;
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (dst[s] != nullptr) *reinterpret_cast<uint4*>(dst[s]) = v[s];
    if (c.narrow) {
      if (((reinterpret_cast<uintptr_t>(c.src) |
            reinterpret_cast<uintptr_t>(c.dst) | c.bytes) & 3) == 0) {
        copy_narrow<uint32_t>(c, lane);
      } else {
        copy_narrow<uint8_t>(c, lane);
      }
      c.narrow = false;
    }
  }
}

}  // namespace

// idx [B,k] int32; for buffer t: dst[t] / src[t] base addresses, row_bytes[t],
// batch and row strides in bytes of the cache (dst_*) and the rows (src_*);
// the work split of plan_units (kernels/scatter_update.py): chunk[t],
// first[t], vec[t], per_row, units per CTA and per warp, and the grid.
extern "C" int spa_scatter_update_multi(
    const void* idx, int B, int k, int N, int nbuf, const long long* dst,
    const long long* src, const long long* row_bytes,
    const long long* dst_bstride, const long long* dst_rstride,
    const long long* src_bstride, const long long* src_rstride,
    const int* chunk, const int* first, const int* vec, int per_row,
    long long upc, int upw, int grid, void* stream) {
  if (B <= 0 || k <= 0 || nbuf == 0 || per_row == 0) return 0;
  const long long units = (long long)B * k * per_row;
  if (nbuf < 0 || nbuf > kMaxBufs || grid <= 0 || upc <= 0 ||
      (long long)upw * kWarps < upc || (long long)grid * upc < units ||
      (long long)B * k > 0x7fffffff || upc + per_row > 0x7fffffff ||
      (upw - 1 + per_row - 1) / per_row + 1 > kWarpRows)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.n = nbuf;
  p.per_row = per_row;
  p.k = k;
  p.N = N;
  p.units = units;
  p.upc = upc;
  p.upw = upw;
  for (int t = 0; t < nbuf; ++t) {
    if (chunk[t] <= 0 || chunk[t] > kUnitMax ||
        (vec[t] != 16 && vec[t] != 4 && vec[t] != 1))
      return (int)cudaErrorInvalidValue;
    p.buf[t] = Buf{reinterpret_cast<char*>(dst[t]),
                   reinterpret_cast<const char*>(src[t]),
                   row_bytes[t],
                   dst_bstride[t],
                   dst_rstride[t],
                   src_bstride[t],
                   src_rstride[t],
                   chunk[t],
                   first[t],
                   vec[t],
                   0};
  }
  scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), p);
  return (int)cudaGetLastError();
}
