// The seam DP's cell rule (SPEC.md §5), dp_block.cu's, so that the
// kernels take the same candidate on a tie (the strip sweep of
// strip_dp.cuh unrolls the same rule).
//
//   M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig[y, x] * rigc[|dx|] )
//
// The best candidate is the first, in the side preference's rank order
// (LEFT: 0, -1, +1, -2, +2, ...; RIGHT: 0, +1, -1, ...), whose cost equals
// the minimum — the rank-order strict-min scan of lqr_tpu/core/dp.py:85.
// The rig term is __fadd_rn(M, __fmul_rn(rig, rigc)) so that it cannot be
// contracted into an FMA whatever the build flags.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// dx of the k-th candidate in rank order (k = 0 .. 2*delta_x)
__device__ __forceinline__ int rank_dx(int k, bool pref_left) {
  if (k == 0) return 0;
  const int m = (k + 1) >> 1;
  const bool first_of_pair = (k & 1) != 0;   // rank 2m-1
  return (first_of_pair == pref_left) ? -m : m;
}

// The minimum over the candidates of column x of the previous DP row
// `prev` ([Wb], +inf outside [0, Wb)); its dx goes to *best_dx. r is
// rig[y, x] (unused when has_rig is false); rigc[m] = f32(m^1.5 / H).
__device__ __forceinline__ float dp_best(const float* prev, int x, int Wb,
                                         float r, bool has_rig,
                                         const float* rigc, int delta_x,
                                         bool pref_left, int* best_dx) {
  float best = INFINITY;
  int best_rank = 127;
  int bdx = 0;
  const int ncand = 2 * delta_x + 1;
  for (int k = 0; k < ncand; ++k) {
    const int dx = rank_dx(k, pref_left);
    const int xn = x + dx;
    float c = (xn >= 0 && xn < Wb) ? prev[xn] : INFINITY;
    if (has_rig && dx != 0)
      c = __fadd_rn(c, __fmul_rn(r, rigc[dx < 0 ? -dx : dx]));
    const bool take = c < best || (c == best && k < best_rank);
    if (take) {
      best = c;
      best_rank = k;
      bdx = dx;
    }
  }
  *best_dx = bdx;
  return best;
}
