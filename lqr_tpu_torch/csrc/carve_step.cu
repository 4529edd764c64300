// The fused seam step's second kernel, CUDA C++ for sm_90a, one launch
// per seam: backtrack_compact. The step's forward DP with the energy
// inline is dp_energy_forward.cu's kernel.
//
// backtrack_compact replaces lqr_tpu/ops/dp_pallas.py:_btcf_kernel (any
// delta_x) and :_btwc_kernel (delta_x = 1, the wedge chase), launched by
// carve_step_pallas after either forward kernel: the start column x_H =
// argmin M_last (leftmost when the side preference is LEFT, else
// rightmost), the chase x_{y-1} = x_y + bp[y, x_y] into seam [H], and the
// compaction of b, and of bias and rig where present, into fresh planes:
//
//   out[y, x] = x < w - 1 ? (x >= seam[y] ? a[y, x + 1] : a[y, x]) : 0
//
// (the roll/select law of core/engine.py). None of the TPU layout is
// carried over: no [f, 128] folds, no wedges, no one-hot walk, no cyclic
// log-reduction of the seam index, no SMEM scalars.
//
// Design. One thread block per kRows rows with no grid-wide barrier:
// every block reduces M_last itself (Wb floats), chases from row H - 1 up
// to its own first row on one thread, writes its rows of seam, and
// compacts its rows with the whole block, reading the old planes and
// writing new ones. The chases run side by side; the longest (the block
// of row 0) is the one chase a single-block backtrack would do. Nothing in
// it scales with Wb but the loops: it takes any width.
//
// What bounds it on this card: a chain of H dependent one-byte L2 loads on
// one thread (block 0's, slower than a lone chase while the other blocks
// chase the same path and compact); the compaction (2 x 16.8 MB per plane
// at 2048^2) spreads over H / kRows blocks and is small beside it. What
// the design does about it: nothing yet beyond the spread compaction; see
// csrc/backtrack.cu's windowed chase for what a later change would try.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seam_dp.cuh"

namespace {

constexpr int kBtThreads = 256;     // backtrack_compact: threads per block
constexpr int kRows = 16;           // backtrack_compact: rows per block

__global__ void __launch_bounds__(kBtThreads)
backtrack_compact_kernel(const float* __restrict__ m_last,
                         const int8_t* __restrict__ bp,
                         const float* __restrict__ b,
                         const float* __restrict__ bias,
                         const float* __restrict__ rig, int pref_left, int H,
                         int Wb, int w, int* __restrict__ seam,
                         float* __restrict__ b_out,
                         float* __restrict__ bias_out,
                         float* __restrict__ rig_out) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_seam[kRows];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = nt >> 5;
  const bool left = pref_left != 0;
  const int y0 = blockIdx.x * kRows;
  const int y1 = min(H, y0 + kRows);

  // ---- start column: the minimum of M_last, then its leftmost (LEFT) or
  // rightmost (RIGHT) column
  float v = INFINITY;
  for (int x = t; x < Wb; x += nt) v = fminf(v, m_last[x]);
  v = warp_min(v);
  if (lane == 0) red_v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_min(lane < nwarps ? red_v[lane] : INFINITY);
    if (lane == 0) red_v[0] = v;
  }
  __syncthreads();
  const float m = red_v[0];
  int idx = left ? Wb : -1;
  for (int x = t; x < Wb; x += nt)
    if (m_last[x] == m) idx = left ? min(idx, x) : max(idx, x);
  idx = warp_pick(idx, left);
  if (lane == 0) red_i[warp] = idx;
  __syncthreads();

  // ---- the chase, on one thread, from row H - 1 up to this block's rows
  if (t == 0) {
    int x = red_i[0];
    for (int k = 1; k < nwarps; ++k)
      x = left ? min(x, red_i[k]) : max(x, red_i[k]);
    for (int y = H - 1; y >= y0; --y) {
      if (y < y1) s_seam[y - y0] = x;
      if (y > y0) x += bp[(size_t)y * Wb + x];
    }
  }
  __syncthreads();
  if (t < y1 - y0) seam[y0 + t] = s_seam[t];

  // ---- compaction of this block's rows into the fresh planes
  for (int y = y0; y < y1; ++y) {
    const int s = s_seam[y - y0];
    const size_t row = (size_t)y * Wb;
    for (int x = t; x < Wb; x += nt) {
      const bool keep = x < w - 1;
      const size_t src = row + (x >= s ? x + 1 : x);
      b_out[row + x] = keep ? b[src] : 0.0f;
      if (bias) bias_out[row + x] = keep ? bias[src] : 0.0f;
      if (rig) rig_out[row + x] = keep ? rig[src] : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// m_last: [Wb] f32 (+inf at lanes >= w); bp: [H, Wb] int8; b, bias, rig:
// [H, Wb] f32 (bias and rig may be null, and then so must their outputs);
// 1 <= w <= Wb; seam: [H] i32 out; b_out, bias_out, rig_out: [H, Wb] f32
// out, not aliasing the inputs. Launches on `stream` and returns the
// launch's cudaError_t (0 on success), clearing it.
int lqr_backtrack_compact(const float* m_last, const int8_t* bp,
                          const float* b, const float* bias, const float* rig,
                          int pref_left, int H, int Wb, int w, int* seam,
                          float* b_out, float* bias_out, float* rig_out,
                          void* stream) {
  if (H < 1 || Wb < 1 || w < 1 || w > Wb || (bias == nullptr) !=
      (bias_out == nullptr) || (rig == nullptr) != (rig_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (H + kRows - 1) / kRows;
  backtrack_compact_kernel<<<blocks, kBtThreads, 0, (cudaStream_t)stream>>>(
      m_last, bp, b, bias, rig, pref_left, H, Wb, w, seam, b_out, bias_out,
      rig_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
