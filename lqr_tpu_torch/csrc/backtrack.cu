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
// Then one warp runs the windowed chase of chase.cuh: windows of 32 rows x
// 144 columns in shared memory, one row a lane, the next window loading
// while the current one is chased.
//
// What bounds it on this card: the chase is a serial chain of H dependent
// steps. The design pays one shared-memory load and an add per step, and
// the L2 latency of a window's loads hides behind the previous window's
// chase instead of costing one latency per row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chase.cuh"

namespace {

constexpr int kThreads = 256;

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

  // 3. the windowed chase, warp 0 (chase.cuh)
  warp_chase<LdgLoad>(bp, Wb, H - 1, s_idx[0], seam, win, t);
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
