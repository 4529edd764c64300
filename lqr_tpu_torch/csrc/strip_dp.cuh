// The forward seam DP's warp-strip routine (SPEC.md §5), shared by
// dp_forward.cu and carve_resident.cu: the helpers and the sweep of one
// CTA's warps over rows 1 .. rows - 1 of a map whose row 0 already stands
// in every CTA's frontier.
//
// Each lane holds 8 consecutive columns of M in registers, so a warp holds
// a window of 256 columns: a strip of S kept columns with a halo of G
// columns on each side. Neighbours inside a lane are registers; across
// lanes they come by __shfl_up/down_sync. A warp runs K = G / delta_x rows
// of its window with no barrier: the cells that depend on columns beyond
// the window shrink by delta_x per row (a trapezoid), and after K rows the
// kept S columns are still exact, since each was computed by the same rule
// from the same inputs. Every K rows each warp writes its kept columns into
// the next frontier row of every block of the cluster (distributed shared
// memory; one global scratch frontier for maps too wide for shared memory),
// one cluster barrier, and each warp reloads its window from its own
// block's copy; the last block's kept columns go to p.m_last (a generic
// pointer: global memory, or one block's shared memory). Columns outside
// [0, Wb) hold E = +inf, so their M stays +inf as the plain version's
// padding is.
//
// Each lane streams the E (and rig) values of its own 8 columns into a
// ring of shared-memory stages with cp.async, 16 rows ahead without rig
// and 8 with it (16 KB per warp either way): 16-byte copies when Wb % 4 ==
// 0 and the planes are 16-byte aligned, else 4-byte copies, each
// predicated inside its asm so that a lane outside the map skips it
// without a divergent branch. A lane reads only what it copied, so
// cp.async.wait_group alone orders the ring; the copies bypass the L1
// (.cg for 16 bytes; the 4-byte .ca copies read planes no block of the
// launch writes during the sweep). Backpointers leave as one 8-byte store
// per lane per row (4-byte or single-byte stores where a row start is not
// aligned).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCols = 8;                    // columns a lane holds
constexpr int kWin = 32 * kCols;            // columns of a warp's window
constexpr int kWarpRing = 16 * 1024;        // ring bytes per warp
constexpr int kMaxWarps = 16;
constexpr int kMaxCtas = 8;                 // portable cluster size
constexpr int kMaxDelta = 10;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* e;
  const float* rig;
  const float* rigc;
  int delta, H, Wb, rows, S, G, K, nstrips, ctas, vec16;
  float* m_last;
  int8_t* bp;
  float* gfront;   // the frontier pair in global memory, or null
};

// A warp's place in its stream of (strip, row) tasks: the K-row block
// starting at y0, strip t, row y.
struct Task {
  int y0, t, y;
};

// A warp runs strips first, first + nwarps, ... below its CTA's `last`.
__device__ __forceinline__ void advance(Task& k, const Params& p, int first,
                                        int last, int nwarps) {
  if (++k.y == min(k.y0 + p.K, p.rows)) {
    k.t += nwarps;
    if (k.t >= last) {
      k.t = first;
      k.y0 += p.K;
    }
    k.y = k.y0;
  }
}

// The copies take their predicate inside the asm, so that a lane outside
// the map skips its copy without a divergent branch.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(s),
      "l"(src), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(s),
      "l"(src), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy row k.y of the lane's 8 window columns of E (and rig) into a ring
// stage; columns outside [0, Wb) get E = +inf, rig = 0.
template <bool kRig>
__device__ __forceinline__ void fetch(const Params& p, const Task& k,
                                      float* es, float* rs, int lane) {
  const int xl = k.t * p.S - p.G + kCols * lane;
  const ptrdiff_t row = (ptrdiff_t)k.y * p.Wb;
  float* de = es + kCols * lane;
  float* dr = rs + kCols * lane;
  if (p.vec16) {
#pragma unroll
    for (int q = 0; q < kCols; q += 4) {
      const int x = xl + q;
      const bool in = x >= 0 && x < p.Wb;  // Wb % 4 == 0: all 4 or none
      cp_async16(de + q, p.e + row + x, in);
      if (kRig) cp_async16(dr + q, p.rig + row + x, in);
      if (!in) {
        *reinterpret_cast<float4*>(de + q) =
            make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
        if (kRig)
          *reinterpret_cast<float4*>(dr + q) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int x = xl + c;
      const bool in = x >= 0 && x < p.Wb;
      cp_async4(de + c, p.e + row + x, in);
      if (kRig) cp_async4(dr + c, p.rig + row + x, in);
      if (!in) {
        de[c] = INFINITY;
        if (kRig) dr[c] = 0.0f;
      }
    }
  }
}

// kOneStrip's refill: row `se` / `sr` of the lane's columns; the slots of
// columns outside [0, Wb) kept their +inf and 0 from the first fill.
template <bool kRig>
__device__ __forceinline__ void fetch_one_strip(const Params& p,
                                                const float* se,
                                                const float* sr, unsigned inr,
                                                float* es, float* rs,
                                                int lane) {
  float* de = es + kCols * lane;
  float* dr = rs + kCols * lane;
  if (p.vec16) {
#pragma unroll
    for (int q = 0; q < kCols; q += 4) {
      cp_async16(de + q, se + q, inr & (1u << q));
      if (kRig) cp_async16(dr + q, sr + q, inr & (1u << q));
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      cp_async4(de + c, se + c, inr & (1u << c));
      if (kRig) cp_async4(dr + c, sr + c, inr & (1u << c));
    }
  }
}

// The lane's 8 columns of a frontier row (+inf outside [0, Wb)).
__device__ __forceinline__ void load_front(float (&m)[kCols], const float* f,
                                           int xl, int Wb) {
  if (xl >= 0 && xl + kCols <= Wb) {
    const float4 a = *reinterpret_cast<const float4*>(f + xl);
    const float4 b = *reinterpret_cast<const float4*>(f + xl + 4);
    m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
    m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int x = xl + c;
      m[c] = (x >= 0 && x < Wb) ? f[x] : INFINITY;
    }
  }
}

// Store the lane's columns below Wb (xl >= 0: a kept lane).
__device__ __forceinline__ void store_front(float* f, const float (&m)[kCols],
                                            int xl, int Wb) {
  if (xl + kCols <= Wb) {
    *reinterpret_cast<float4*>(f + xl) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(f + xl + 4) =
        make_float4(m[4], m[5], m[6], m[7]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (xl + c < Wb) f[xl + c] = m[c];
  }
}

// The lane's 8 backpointers of one row, packed little-endian in w0, w1.
__device__ __forceinline__ void store_bp(int8_t* row, int xl, int Wb,
                                         uint32_t w0, uint32_t w1) {
  int8_t* d = row + xl;
  const uintptr_t a = reinterpret_cast<uintptr_t>(d);
  if (xl + kCols <= Wb && (a & 7) == 0) {
    *reinterpret_cast<uint2*>(d) = make_uint2(w0, w1);
  } else if (xl + kCols <= Wb && (a & 3) == 0) {
    *reinterpret_cast<uint32_t*>(d) = w0;
    *reinterpret_cast<uint32_t*>(d + 4) = w1;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (xl + c < Wb)
        d[c] = (int8_t)(((c < 4 ? w0 : w1) >> (8 * (c & 3))) & 0xffu);
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__host__ __device__ constexpr int max_delta(int kDelta) { return kDelta >= 0 ? kDelta : kMaxDelta; }

// One row of the lane's 8 columns: M in place, backpointers packed in w0,
// w1. kDelta < 0: delta_x at run time, up to kMaxDelta.
template <int kDelta, bool kLeft, bool kRig>
__device__ __forceinline__ void row_step(
    float (&m)[kCols], const float (&e)[kCols], const float (&r)[kCols],
    const float (&rc)[max_delta(kDelta) + 1], int delta, uint32_t& w0,
    uint32_t& w1) {
  constexpr int DM = max_delta(kDelta);
  // L[o]: M at the lane's column -o; R[o]: at column 7 + o (lanes beyond
  // the window give values no kept cell reads)
  float L[DM + 1], R[DM + 1];
#pragma unroll
  for (int o = 0; o <= DM; ++o) L[o] = R[o] = 0.0f;
#pragma unroll
  for (int o = 1; o <= DM; ++o) {
    if (kDelta >= 0 || o <= delta) {
      const int q = (o + kCols - 1) / kCols;
      L[o] = __shfl_up_sync(kFull, m[q * kCols - o], q);
      R[o] = __shfl_down_sync(kFull, m[o - 1 - (q - 1) * kCols], q);
    }
  }
#define LQR_AT(j) ((j) < 0 ? L[-(j)] : ((j) >= kCols ? R[(j) - kCols + 1] : m[(j)]))
  float nm[kCols];
  int bd[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    float best = m[c];
    int b = 0;
#pragma unroll
    for (int k = 1; k <= DM; ++k) {
      if (kDelta >= 0 || k <= delta) {
        const int d1 = kLeft ? -k : k;       // the first of the pair in rank
        const float w = kRig ? __fmul_rn(r[c], rc[k]) : 0.0f;
        float c1 = LQR_AT(c + d1);
        if (kRig) c1 = __fadd_rn(c1, w);
        if (c1 < best) {
          best = c1;
          b = d1;
        }
        float c2 = LQR_AT(c - d1);
        if (kRig) c2 = __fadd_rn(c2, w);
        if (c2 < best) {
          best = c2;
          b = -d1;
        }
      }
    }
    nm[c] = __fadd_rn(e[c], best);
    bd[c] = b;
  }
#undef LQR_AT
#pragma unroll
  for (int c = 0; c < kCols; ++c) m[c] = nm[c];
  w0 = pack4(bd[0], bd[1], bd[2], bd[3]);
  w1 = pack4(bd[4], bd[5], bd[6], bd[7]);
}

// Ring stages per warp: 16 KB of E (and rig) rows
template <bool kRig>
__host__ __device__ constexpr int ring_depth() { return kRig ? 8 : 16; }

// The sweep of rows 1 .. p.rows - 1 by one CTA's warps (the text of
// strip_sweep.inc, which dp_forward.cu's kernel includes too). This warp
// runs the strips first, first + nwarps, ... below hi (first >= hi: none,
// it only meets the cluster's barriers); ering / rring: its E and rig
// rings; front: this CTA's frontier pair, row 0 in its first half. Every
// CTA of the cluster calls it, with the same p.rows and p.K.
template <int kDelta, bool kLeft, bool kRig, bool kOneStrip>
__device__ __forceinline__ void strip_sweep(
    const Params p, float* ering, float* rring, float* front, int first,
    int hi, int nwarps, int lane, cg::cluster_group cluster) {
  constexpr int D = ring_depth<kRig>();
  constexpr int DM = max_delta(kDelta);
  const int delta = kDelta >= 0 ? kDelta : p.delta;
  const int Wp = (p.Wb + 3) & ~3;
#include "strip_sweep.inc"
}

}  // namespace
