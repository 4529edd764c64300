// The energy of one pixel from the reader plane (SPEC.md §2), shared by
// carve_resident.cu and dp_energy_forward.cu so that both kernels compute
// it in the op order of core/energy.py (dp_energy_forward.cu's row 0 also
// with load_px's loads):
//
//   gx = (b[y, x+1] - b[y, x-1]) * 0.5          edges replicated at lane 0
//                                               and lane w - 1
//   gy = (b[y+1, x] - b[y-1, x]) * 0.5          rows replicated at 0, h - 1
//   XABS |gx|; SUMABS (|gx| + |gy|) * 0.5; NORM sqrt(gx*gx + gy*gy); NULL 0
//
// plus the bias where present. Every op is an explicitly rounded intrinsic,
// so no build flag can contract or approximate it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Family { kXabs = 0, kSumabs = 1, kNorm = 2, kNull = 3 };

// A column's inputs of one row: reader plane to the left and right (edges
// replicated), above and below (rows replicated), bias and rig.
struct Px {
  float l, r, u, d, bias, rig;
};

// A kernel that reads and writes its planes in one launch takes no pointer
// to them that is both const and __restrict__: a non-coherent load
// (ld.global.nc) could return a value from before the last compaction.
__device__ __forceinline__ void load_px(Px& p, const float* b,
                                        const float* bias, const float* rig,
                                        int fam, int y, int x, int h, int Wb,
                                        int w) {
  const size_t at = (size_t)y * Wb + x;
  if (fam != kNull) {
    p.l = b[x > 0 ? at - 1 : at];
    p.r = b[x < w - 1 ? at + 1 : at];
    if (fam != kXabs) {
      p.u = b[(size_t)(y > 0 ? y - 1 : 0) * Wb + x];
      p.d = b[(size_t)(y < h - 1 ? y + 1 : y) * Wb + x];
    }
  }
  if (bias) p.bias = bias[at];
  if (rig) p.rig = rig[at];
}

// energy + bias of one pixel, in the op order of core/energy.py
__device__ __forceinline__ float energy(const Px& p, int fam, bool has_bias) {
  float e = 0.0f;
  if (fam != kNull) {
    const float gx = __fmul_rn(__fsub_rn(p.r, p.l), 0.5f);
    if (fam == kXabs) {
      e = fabsf(gx);
    } else {
      const float gy = __fmul_rn(__fsub_rn(p.d, p.u), 0.5f);
      if (fam == kSumabs)
        e = __fmul_rn(__fadd_rn(fabsf(gx), fabsf(gy)), 0.5f);
      else
        e = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
    }
  }
  return has_bias ? __fadd_rn(e, p.bias) : e;
}

}  // namespace
