// Seam backtrack (SPEC.md §5) for one image, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels lqr_tpu/ops/dp_pallas.py:_btw_kernel (the
// delta_x = 1 wedge backtrack launched by find_seam_pallas), :_btf_kernel
// (the folded one-hot walk for any delta_x) and :_bt_kernel (the unfolded
// one-hot walk launched by backtrack_pallas). On the TPU those vectorized
// the chase as one-hot rows; here it is a pointer chase through windows.
//
//   x_{H-1} = argmin_x M_last[x], ties to the smallest x if the side
//             preference is LEFT, else to the largest x
//   x_{y-1} = x_y + bp[y, x_y]            seam[y] = x_y
//
// Design: one thread block. A block-wide reduction finds the minimum of
// M_last, a second one the leftmost (LEFT) or rightmost (RIGHT) column
// equal to it (torch.argmin's first-index rule would be wrong for RIGHT).
// Then one warp chases through windows: from row y at column x it holds
// the bp window of rows y - 31 .. y and 144 columns from about x - 64
// (clamped to the map) in shared memory, one row a lane, and chases from
// there until the window's rows end or the seam leaves its columns: 32
// steps unrolled, each a shared-memory load and an add, the window test
// kept off that chain. While it chases, the next window (the 32 rows
// below, the same columns) is already loading into registers, nine 16-byte
// loads a lane in flight at once, and lands in the other half of a double
// buffer; a seam that left the columns (delta_x > 2 can) gets a window
// loaded where it is. Maps with Wb % 16 != 0 or below 144 columns load
// single bytes, one window at a time. The kernel needs no delta_x: the
// window follows the seam.
//
// What bounds it on this card: the chase is a serial chain of H dependent
// steps. The design pays one shared-memory load and an add per step, and
// the L2 latency of a window's loads hides behind the previous window's
// chase instead of costing one latency per row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;       // rows of a chase window, one a lane
constexpr int kReach = 64;      // columns left of the window's centre
constexpr int kSpan = 144;      // window columns: 9 vectors of 16 bytes
constexpr int kVecs = kSpan / 16;

struct Window {
  int top, n, lo;               // rows top, top - 1, ..., top - n + 1
};

// The window of rows below `top` around column x, clamped to the map.
__device__ __forceinline__ Window window_at(int top, int x, int Wb, int span,
                                            bool vec) {
  int lo = min(max(x - kReach, 0), Wb - span);
  if (vec) lo &= ~15;
  return Window{top, min(kRows, top + 1), lo};
}

// Lane r's row of a window (row top - r), as 16-byte vectors.
__device__ __forceinline__ void load_row(uint4 (&v)[kVecs], const int8_t* bp,
                                         int Wb, const Window& w, int lane) {
  if (lane < w.n) {
    const uint4* src = reinterpret_cast<const uint4*>(
        bp + (size_t)(w.top - lane) * Wb + w.lo);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = __ldg(src + k);
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
__device__ __forceinline__ void fill_bytes(int8_t* win, const int8_t* bp,
                                           int Wb, int span, const Window& w,
                                           int lane) {
  if (lane < w.n) {
    const int8_t* src = bp + (size_t)(w.top - lane) * Wb + w.lo;
    for (int c = 0; c < span; ++c) win[lane * kSpan + c] = src[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    backtrack_kernel(const float* __restrict__ m_last,
                     const int8_t* __restrict__ bp, int pref_left, int Wb,
                     int H, int* __restrict__ seam) {
  __shared__ float s_val[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ __align__(16) int8_t win[2][kRows * kSpan];
  const int t = threadIdx.x;
  const bool left = pref_left != 0;

  // 1. the minimum of the last DP row
  float v = INFINITY;
  for (int x = t; x < Wb; x += blockDim.x) v = fminf(v, m_last[x]);
  s_val[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) s_val[t] = fminf(s_val[t], s_val[t + s]);
    __syncthreads();
  }
  const float m = s_val[0];

  // 2. the leftmost (LEFT) or rightmost (RIGHT) column holding it
  int idx = left ? Wb : -1;
  for (int x = t; x < Wb; x += blockDim.x) {
    if (m_last[x] == m) idx = left ? min(idx, x) : max(idx, x);
  }
  s_idx[t] = idx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      s_idx[t] = left ? min(s_idx[t], s_idx[t + s])
                      : max(s_idx[t], s_idx[t + s]);
    }
    __syncthreads();
  }
  if (t >= 32) return;

  // 3. the windowed chase, warp 0; every lane walks the same path. While
  // it chases one window, the next one's loads (the rows below, centred
  // on the column where this window began) are in flight.
  const int lane = t;
  const bool vec = Wb % 16 == 0 && Wb >= kSpan &&
                   reinterpret_cast<uintptr_t>(bp) % 16 == 0;
  const int span = min(kSpan, Wb);
  uint4 buf[kVecs];
  int x = s_idx[0];
  int y = H - 1;
  int cur = 0;
  Window w = window_at(y, x, Wb, span, vec);
  if (vec) {
    load_row(buf, bp, Wb, w, lane);
    store_row(buf, win[cur], w, lane);
  } else {
    fill_bytes(win[cur], bp, Wb, span, w, lane);
  }
  __syncwarp();
  while (y >= 0) {
    // the next window, speculatively (the vector path)
    const Window nw = window_at(y - w.n, x, Wb, span, vec);
    const bool ahead = vec && nw.top >= 0;
    if (ahead) load_row(buf, bp, Wb, nw, lane);
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
    if (y < 0) break;
    cur ^= 1;
    if (ahead && r == w.n && (unsigned)(x - nw.lo) < (unsigned)span) {
      w = nw;
      store_row(buf, win[cur], w, lane);
    } else {                 // the seam left its columns: load where it is
      w = window_at(y, x, Wb, span, vec);
      if (vec) {
        load_row(buf, bp, Wb, w, lane);
        store_row(buf, win[cur], w, lane);
      } else {
        fill_bytes(win[cur], bp, Wb, span, w, lane);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// m_last: [Wb] f32 (+inf at invalid lanes); bp: [H, Wb] int8; seam: [H]
// int32. Launches on `stream` and returns the launch's cudaError_t (0 on
// success), clearing it.
int lqr_backtrack(const float* m_last, const int8_t* bp, int pref_left,
                  int Wb, int H, int* seam, void* stream) {
  if (H < 1 || Wb < 1) return (int)cudaErrorInvalidValue;
  backtrack_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      m_last, bp, pref_left, Wb, H, seam);
  return (int)cudaGetLastError();
}

}  // extern "C"
