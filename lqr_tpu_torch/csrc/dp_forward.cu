// Forward seam DP (SPEC.md §5) for one image, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels lqr_tpu/ops/dp_pallas.py:_dpf_kernel
// (folded rows, wedge form at delta_x = 1, rank form otherwise; launched by
// find_seam_pallas) and :_dp_kernel (the unfolded form, launched by
// dp_forward_pallas where no fold applies or H % BR != 0). Same math, none
// of the TPU layout: no [f, 128] folds, no wedge, no SMEM scalars.
//
//   M[0, x] = E[0, x]                                      bp[0, x] = 0
//   M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig[y, x] * rigc[|dx|] )
//
// Out-of-range neighbours are +inf. bp[y, x] is the first candidate, in the
// side preference's rank order (LEFT: 0, -1, +1, -2, ...; RIGHT: 0, +1, -1,
// ...), whose cost equals the minimum: the cell rule of seam_dp.cuh, here
// unrolled at compile time. rigc[m] = f32(m^1.5 / H) comes from the host,
// rounded once from f64; the rig term is __fadd_rn(M, __fmul_rn(rig, rigc)).
//
// Design: warp strips with K-row halos over a prefetched row ring, on a
// thread-block cluster. Each lane holds 8 consecutive columns of M in
// registers, so a warp holds a window of 256 columns: a strip of S kept
// columns with a halo of G columns on each side. Neighbours inside a lane
// are registers; across lanes they come by __shfl_up/down_sync. A warp
// runs K = G / delta_x rows of its window with no barrier: the cells that
// depend on columns beyond the window shrink by delta_x per row (a
// trapezoid), and after K rows the kept S columns are still exact, since
// each was computed by the same rule from the same inputs. Every K rows
// each warp writes its kept columns into the next frontier row of every
// block of the cluster (distributed shared memory; one global scratch
// frontier for maps too wide for shared memory), one cluster barrier, and
// each warp reloads its window from its own block's copy. Columns outside
// [0, Wb) hold E = +inf, so their M stays +inf as the plain version's
// padding is. The strips are split over up to 8 blocks of up to 4 warps
// (one warp on each of an SM's schedulers); wider maps give each warp
// several strips, run in turn before the barrier.
//
// Each lane streams the E (and rig) values of its own 8 columns into a
// ring of shared-memory stages with cp.async, 16 rows ahead without rig
// and 8 with it (16 KB per warp either way): 16-byte copies when Wb % 4 ==
// 0 and the planes are 16-byte aligned, else 4-byte copies, each
// predicated inside its asm so that a lane outside the map skips it
// without a divergent branch. A lane reads only what it copied, so
// cp.async.wait_group alone orders the ring. Backpointers leave as one
// 8-byte store per lane per row (4-byte or single-byte stores where a row
// start is not aligned).
//
// Ragged batches: rows y >= h (the image's true height inside a buffer of
// H rows) are pass-through rows, as in lqr_tpu/core/dp.py:90-93: the
// frontier rides through unchanged and bp = 0, so M_last is row h - 1's.
//
// What bounds it on this card: each warp's own row, a serial chain of about
// 100 instructions (8 cells of compare-and-select at delta_x = 1, the
// shuffles, the byte packing, the store, the ring's copies) that no other
// warp of its scheduler hides: about 0.26 us a row at 2048 columns on an
// H100, whether the strips run on 2, 4 or 8 SMs. Neither bytes (the map
// streams at about 40 GB/s) nor an SM's issue rate (one block of 12 warps
// runs only 1.3x slower than four blocks of 4) is the limit. What the design does
// about it: no cell waits on a global load, one barrier per K rows instead
// of one per row (K = 64 at delta_x = 1: each exchange costs about a
// microsecond), the candidate loop unrolled at compile time for delta_x =
// 0..3 (a run-time delta_x up to 10 takes a guarded unroll) and both side
// preferences, and no divergent branch on the map's edges (an edge warp
// that diverged held every other warp at the barrier). The geometry
// (blocks, warps, S, G, K) comes from the caller
// (lqr_tpu_torch/ops/dp_cuda.py:strip_geometry); the launcher checks it.
// Maps whose planes fit the L2 skip this kernel: carve_resident.cu carves
// a whole chunk of seams in one launch.

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
constexpr int kDefaultSmem = 48 * 1024;
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

// kSolo's refill: row `se` / `sr` of the lane's columns; the slots of
// columns outside [0, Wb) kept their +inf and 0 from the first fill.
template <bool kRig>
__device__ __forceinline__ void fetch_solo(const Params& p, const float* se,
                                           const float* sr, unsigned inr,
                                           float* es, float* rs, int lane) {
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

// Zero n bytes from p with the whole block: 16-byte stores in the aligned
// middle.
__device__ void zero_bytes(int8_t* p, size_t n) {
  const size_t lead = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  const size_t head = n < lead ? n : lead;
  for (size_t i = threadIdx.x; i < head; i += blockDim.x) p[i] = 0;
  const size_t nq = (n - head) / 16;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (size_t i = threadIdx.x; i < nq; i += blockDim.x)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
  for (size_t i = head + nq * 16 + threadIdx.x; i < n; i += blockDim.x)
    p[i] = 0;
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

// kSolo: one strip per warp (nstrips == warps), so a lane's columns never
// change: the ring's out-of-range slots are filled with +inf once, a refill
// is row y + D of the same columns, and the lane's pointers advance by a
// row. Otherwise the (strip, row) task stream of `advance`.
template <int kDelta, bool kLeft, bool kRig, bool kSolo>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dp_strips_kernel(const Params p) {
  constexpr int D = kRig ? 8 : 16;           // ring stages
  constexpr int DM = max_delta(kDelta);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int delta = kDelta >= 0 ? kDelta : p.delta;
  // this CTA's strips of the cluster's, [lo, hi)
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lo = (int)((long long)rank * p.nstrips / p.ctas);
  const int hi = (int)((long long)(rank + 1) * p.nstrips / p.ctas);
  const int first = lo + warp;
  float* ering = smem + (size_t)warp * D * kWin;
  float* rring = smem + (size_t)(nwarps + warp) * D * kWin;
  const int Wp = (p.Wb + 3) & ~3;
  float* front = p.gfront ? p.gfront
                          : smem + (size_t)nwarps * D * kWin * (kRig ? 2 : 1);

  // row 0: M = E[0] in every CTA's frontier, bp = 0; rows >= h pass
  // through with bp = 0
  for (int x = threadIdx.x; x < p.Wb; x += blockDim.x) front[x] = p.e[x];
  if (rank == 0) {
    zero_bytes(p.bp, (size_t)p.Wb);
    zero_bytes(p.bp + (size_t)p.rows * p.Wb, (size_t)(p.H - p.rows) * p.Wb);
  }
  if (p.rows == 1) {
    if (rank == 0)
      for (int x = threadIdx.x; x < p.Wb; x += blockDim.x)
        p.m_last[x] = p.e[x];
    return;
  }

  float rc[DM + 1];
#pragma unroll
  for (int k = 0; k <= DM; ++k)
    rc[k] = (kRig && k >= 1 && (kDelta >= 0 || k <= delta)) ? p.rigc[k] : 0.f;

  // fill the ring: the first D tasks, one commit group each (empty past
  // the last task, so that wait_group<D - 1> counts the same everywhere)
  Task pk = first < hi ? Task{1, first, 1} : Task{p.rows, first, p.rows};
#pragma unroll 1
  for (int s = 0; s < D; ++s) {
    if (pk.y0 < p.rows) {
      fetch<kRig>(p, pk, ering + s * kWin, rring + s * kWin, lane);
      advance(pk, p, first, hi, nwarps);
    }
    cp_async_commit();
  }
  // kSolo: the lane's columns, the groups of 4 (vec16) or the columns
  // (else) inside [0, Wb) as a bit mask, and its row pointers
  const int xs = first * p.S - p.G + kCols * lane;
  unsigned inr = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    inr |= (xs + c >= 0 && xs + c < p.Wb ? 1u : 0u) << c;
  const float* se = p.e + xs + (ptrdiff_t)(D + 1) * p.Wb;
  const float* sr = kRig ? p.rig + xs + (ptrdiff_t)(D + 1) * p.Wb : nullptr;
  const bool bp8 = p.Wb % 8 == 0 && reinterpret_cast<uintptr_t>(p.bp) % 8 == 0;
  // row 0 of the frontier; every CTA of the cluster runs before any
  // writes another's shared memory
  cluster.sync();

  const int keep_lo = p.G / kCols, keep_hi = (p.G + p.S) / kCols;
  const bool kept = lane >= keep_lo && lane < keep_hi;
  int stage = 0, kb = 0;
  for (int y0 = 1; y0 < p.rows; y0 += p.K, ++kb) {
    const int y1 = min(y0 + p.K, p.rows);
    const float* cur = front + (size_t)(kb & 1) * Wp;
    const bool last = y1 == p.rows;
    float* nxt = front + (size_t)((kb + 1) & 1) * Wp;
    for (int t = first; t < hi; t += nwarps) {
      const int xl = t * p.S - p.G + kCols * lane;
      // the lane's backpointer stores: 0 none, 1 one 8-byte store, 2 the
      // general store_bp (a row start not 8-byte aligned, or the map's
      // right edge inside the lane)
      const int mode = !kept || xl >= p.Wb ? 0
                       : (bp8 && xl + kCols <= p.Wb ? 1 : 2);
      float m[kCols];
      load_front(m, cur, xl, p.Wb);
      for (int y = y0; y < y1; ++y) {
        cp_async_wait<D - 1>();
        const float* es = ering + stage * kWin + kCols * lane;
        float e[kCols], r[kCols];
        const float4 e0 = *reinterpret_cast<const float4*>(es);
        const float4 e1 = *reinterpret_cast<const float4*>(es + 4);
        e[0] = e0.x; e[1] = e0.y; e[2] = e0.z; e[3] = e0.w;
        e[4] = e1.x; e[5] = e1.y; e[6] = e1.z; e[7] = e1.w;
        if (kRig) {
          const float* rs = rring + stage * kWin + kCols * lane;
          const float4 r0 = *reinterpret_cast<const float4*>(rs);
          const float4 r1 = *reinterpret_cast<const float4*>(rs + 4);
          r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
          r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) r[c] = 0.0f;
        }
        uint32_t w0, w1;
        row_step<kDelta, kLeft, kRig>(m, e, r, rc, delta, w0, w1);
        // the stage was read (its values are used above): refill it
        if (mode == 1)
          *reinterpret_cast<uint2*>(p.bp + (size_t)y * p.Wb + xl) =
              make_uint2(w0, w1);
        else if (mode == 2)
          store_bp(p.bp + (size_t)y * p.Wb, xl, p.Wb, w0, w1);
        if (kSolo) {
          if (y + D < p.rows)
            fetch_solo<kRig>(p, se, sr, inr, ering + stage * kWin,
                             rring + stage * kWin, lane);
          se += p.Wb;
          if (kRig) sr += p.Wb;
        } else {
          if (pk.y0 < p.rows) {
            fetch<kRig>(p, pk, ering + stage * kWin, rring + stage * kWin,
                        lane);
            advance(pk, p, first, hi, nwarps);
          }
        }
        cp_async_commit();
        stage = stage + 1 == D ? 0 : stage + 1;
      }
      // the kept columns: M_last, or the next frontier of every CTA (one
      // global frontier for wide maps)
      if (kept) {
        if (last || p.gfront) {
          store_front(last ? p.m_last : nxt, m, xl, p.Wb);
        } else {
          for (int q = 0; q < p.ctas; ++q)
            store_front(cluster.map_shared_rank(nxt, q), m, xl, p.Wb);
        }
      }
    }
    if (p.gfront) __threadfence();
    cluster.sync();
  }
}

using Kernel = void (*)(Params);

template <int kDelta, bool kSolo>
Kernel pick(bool left, bool rig) {
  if (left)
    return rig ? dp_strips_kernel<kDelta, true, true, kSolo>
               : dp_strips_kernel<kDelta, true, false, kSolo>;
  return rig ? dp_strips_kernel<kDelta, false, true, kSolo>
             : dp_strips_kernel<kDelta, false, false, kSolo>;
}

template <bool kSolo>
Kernel kernel_for(int delta, bool left, bool rig) {
  switch (delta) {
    case 0: return pick<0, kSolo>(left, rig);
    case 1: return pick<1, kSolo>(left, rig);
    case 2: return pick<2, kSolo>(left, rig);
    case 3: return pick<3, kSolo>(left, rig);
    default: return pick<-1, kSolo>(left, rig);
  }
}

}  // namespace

extern "C" {

// The opt-in shared memory per block of the current device, in bytes, or
// a negative cudaError_t.
int lqr_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return bytes;
}

// e, rig: [H, Wb] f32 (rig may be null); rigc: [delta_x + 1] f32 on the
// device; h: the true height, 1 <= h <= H (rows >= h pass through);
// ctas, nwarps, S, G, K: the strip geometry (ops/dp_cuda.py:
// strip_geometry): a cluster of ctas (1..8) blocks of nwarps warps, S + 2 *
// G == 256, S a positive multiple of 16, G >= delta_x * K, K >= 1, ctas and
// nwarps each at most ceil(Wb / S); m_last: [Wb] f32; bp: [H, Wb] int8;
// scratch:
// null, or [2 * round_up(Wb, 4)] f32 on the device to hold the frontier
// pair when it and the ring do not fit the opt-in shared memory together.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success), clearing it so that it does not surface later in an unrelated
// call. A geometry or shared-memory size the kernel cannot take never
// launches.
int lqr_dp_forward(const float* e, const float* rig, const float* rigc,
                   int pref_left, int delta_x, int H, int Wb, int h,
                   int ctas, int nwarps, int S, int G, int K, float* m_last,
                   int8_t* bp, float* scratch, void* stream) {
  if (H < 1 || Wb < 1 || h < 1 || h > H || delta_x < 0 ||
      delta_x > kMaxDelta)
    return (int)cudaErrorInvalidValue;
  const int nstrips = S > 0 ? (Wb + S - 1) / S : 0;
  if (S <= 0 || S % 16 != 0 || S + 2 * G != kWin || K < 1 ||
      (long long)delta_x * K > G || nwarps < 1 || nwarps > kMaxWarps ||
      nwarps > nstrips || ctas < 1 || ctas > kMaxCtas || ctas > nstrips)
    return (int)cudaErrorInvalidValue;
  const int optin = lqr_smem_optin();
  if (optin < 0) return -optin;
  const size_t front = scratch ? 0 : (size_t)2 * ((Wb + 3) & ~3) * 4;
  const size_t smem = (size_t)nwarps * kWarpRing + front;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const bool has_rig = rig != nullptr;
  const bool vec16 = Wb % 4 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0 &&
                     (!has_rig || reinterpret_cast<uintptr_t>(rig) % 16 == 0);
  Kernel kern = ctas * nwarps == nstrips
                    ? kernel_for<true>(delta_x, pref_left != 0, has_rig)
                    : kernel_for<false>(delta_x, pref_left != 0, has_rig);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const Params p{e, rig, rigc, delta_x, H, Wb, h, S, G, K, nstrips,
                 ctas, vec16 ? 1 : 0, m_last, bp, scratch};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(nwarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* lqr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
