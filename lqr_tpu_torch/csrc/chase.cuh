// The windowed warp chase of a seam (SPEC.md §5), shared by backtrack.cu,
// carve_resident.cu and carve_step.cu:
//
//   x_{y-1} = x_y + bp[y, x_y]            seam[y] = x_y
//
// One warp chases through windows: from row y at column x it holds the bp
// window of rows y - 31 .. y and 144 columns from about x - 64 (clamped to
// the map) in shared memory, one row a lane, and chases from there until
// the window's rows end or the seam leaves its columns: 32 steps unrolled,
// each a shared-memory load and an add, the window test kept off that
// chain. While it chases, the next window (the 32 rows below, the same
// columns) is already loading into registers, nine 16-byte loads a lane in
// flight at once, and lands in the other half of a double buffer; a seam
// that left the columns (delta_x > 2 can) gets a window loaded where it
// is. Maps with Wb % 16 != 0 or below 144 columns load single bytes, one
// window at a time. The chase needs no delta_x: the window follows the
// seam.
//
// The loads go through a policy (Ld): backtrack.cu reads a bp that no
// launch of its own writes (__ldg); the resident kernel reads the bp its
// other blocks wrote earlier in the same launch, so it loads past the L1
// (__ldcg). A second policy (Pub) hears, after each window's rows are in
// seam[], that every row >= y is: backtrack.cu and the resident kernel
// publish nothing (NoPublish); carve_step.cu's chase hands each window to
// a publisher warp for the blocks that compact behind it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;       // rows of a chase window, one a lane
constexpr int kReach = 64;      // columns left of the window's centre
constexpr int kSpan = 144;      // window columns: 9 vectors of 16 bytes
constexpr int kVecs = kSpan / 16;

struct Window {
  int top, n, lo;               // rows top, top - 1, ..., top - n + 1
};

// bp read through the non-coherent cache: for a bp no other block of the
// launch writes
struct LdgLoad {
  static __device__ __forceinline__ uint4 vec(const uint4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ int8_t byte(const int8_t* p) {
    return *p;
  }
};

// The chase's start column, reduced over a block as (value, column)
// pairs: the larger-is-better test of a candidate (v, x) against the best
// so far (a smaller value, or the same value further LEFT / RIGHT), and
// its butterfly over a warp.
__device__ __forceinline__ bool better(float v, int x, float bv, int bx,
                                       bool left) {
  return v < bv || (v == bv && (left ? x < bx : x > bx));
}

__device__ __forceinline__ void warp_best(float& v, int& x, bool left) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int ox = __shfl_xor_sync(0xffffffffu, x, o);
    if (better(ov, ox, v, x, left)) {
      v = ov;
      x = ox;
    }
  }
}

// No publication: rows_from(y, lane) is called with every row >= y in
// seam[] (y <= 0: every row), by every lane of the chasing warp.
struct NoPublish {
  __device__ __forceinline__ void rows_from(int, int) const {}
};

// The window of rows below `top` around column x, clamped to the map.
__device__ __forceinline__ Window window_at(int top, int x, int Wb, int span,
                                            bool vec) {
  int lo = min(max(x - kReach, 0), Wb - span);
  if (vec) lo &= ~15;
  return Window{top, min(kRows, top + 1), lo};
}

// Lane r's row of a window (row top - r), as 16-byte vectors.
template <class Ld>
__device__ __forceinline__ void load_row(uint4 (&v)[kVecs], const int8_t* bp,
                                         int Wb, const Window& w, int lane) {
  if (lane < w.n) {
    const uint4* src = reinterpret_cast<const uint4*>(
        bp + (size_t)(w.top - lane) * Wb + w.lo);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = Ld::vec(src + k);
  }
}

__device__ __forceinline__ void store_row(const uint4 (&v)[kVecs],
                                          int8_t* win, const Window& w,
                                          int lane) {
  if (lane < w.n) {
    uint4* dst = reinterpret_cast<uint4*>(win + lane * kSpan);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) dst[k] = v[k];
  }
}

// The byte path (Wb % 16 != 0, or a map narrower than a window).
template <class Ld>
__device__ __forceinline__ void fill_bytes(int8_t* win, const int8_t* bp,
                                           int Wb, int span, const Window& w,
                                           int lane) {
  if (lane < w.n) {
    const int8_t* src = bp + (size_t)(w.top - lane) * Wb + w.lo;
    for (int c = 0; c < span; ++c) win[lane * kSpan + c] = Ld::byte(src + c);
  }
}

// The chase of one warp from column x of row `top` down to row 0; every
// lane walks the same path and lane r writes the rows r, r + 32, ... of
// each window into seam[]. win: two windows of kRows * kSpan bytes in
// shared memory, 16-byte aligned. While it chases one window, the next
// one's loads (the rows below, centred on the column where this window
// began) are in flight. After each window's rows are stored, pub hears
// from every lane which rows are in seam[].
template <class Ld, class Pub = NoPublish>
__device__ __forceinline__ void warp_chase(const int8_t* __restrict__ bp,
                                           int Wb, int top, int x,
                                           int* __restrict__ seam,
                                           int8_t (*win)[kRows * kSpan],
                                           int lane, Pub pub = Pub()) {
  const bool vec = Wb % 16 == 0 && Wb >= kSpan &&
                   reinterpret_cast<uintptr_t>(bp) % 16 == 0;
  const int span = min(kSpan, Wb);
  uint4 buf[kVecs];
  int y = top;
  int cur = 0;
  Window w = window_at(y, x, Wb, span, vec);
  if (vec) {
    load_row<Ld>(buf, bp, Wb, w, lane);
    store_row(buf, win[cur], w, lane);
  } else {
    fill_bytes<Ld>(win[cur], bp, Wb, span, w, lane);
  }
  __syncwarp();
  while (y >= 0) {
    // the next window, speculatively (the vector path)
    const Window nw = window_at(y - w.n, x, Wb, span, vec);
    const bool ahead = vec && nw.top >= 0;
    if (ahead) load_row<Ld>(buf, bp, Wb, nw, lane);
    // chase from the window; xo = x - lo. r: the steps inside the window
    const int8_t* wc = win[cur];
    int xo = x - w.lo, mine = 0, r = 0;
    if (w.n == kRows) {
      // a full window: 32 steps unrolled, the window test off the chain
      // (an index clamped into the window, the steps counted while inside;
      // a separate loop for the last, shorter window keeps k < n out of
      // these steps)
      bool inside = true;
      int x_out = xo;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const bool in = (unsigned)xo < (unsigned)span;
        if (inside && !in) x_out = xo;
        inside = inside && in;
        r += inside ? 1 : 0;
        if (lane == k) mine = xo;
        xo += wc[k * kSpan + min((unsigned)xo, (unsigned)(span - 1))];
      }
      if (!inside) xo = x_out;
    } else {
      while (r < w.n && (unsigned)xo < (unsigned)span) {
        if (lane == r) mine = xo;
        xo += wc[r * kSpan + xo];
        ++r;
      }
    }
    if (lane < r) seam[y - lane] = mine + w.lo;
    x = xo + w.lo;
    if (r == 0) break;       // x left [0, Wb): bp did not come from the DP
    y -= r;
    pub.rows_from(y + 1, lane);
    if (y < 0) break;
    cur ^= 1;
    if (ahead && r == w.n && (unsigned)(x - nw.lo) < (unsigned)span) {
      w = nw;
      store_row(buf, win[cur], w, lane);
    } else {                 // the seam left its columns: load where it is
      w = window_at(y, x, Wb, span, vec);
      if (vec) {
        load_row<Ld>(buf, bp, Wb, w, lane);
        store_row(buf, win[cur], w, lane);
      } else {
        fill_bytes<Ld>(win[cur], bp, Wb, span, w, lane);
      }
    }
    __syncwarp();
  }
}

}  // namespace
