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
// thread-block cluster: the sweep of strip_dp.cuh (shared with
// carve_resident.cu), whose header describes the strips, the halos, the
// frontier exchange and the ring. The strips are split over up to 8 blocks
// of up to 4 warps (one warp on each of an SM's schedulers); wider maps
// give each warp several strips, run in turn before the barrier. This
// kernel puts row 0 into every block's frontier, zeroes bp's row 0 and its
// pass-through rows, and hands the last row to m_last.
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

#include "strip_dp.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kDefaultSmem = 48 * 1024;

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

// kOneStrip: one strip per warp (nstrips == warps), so a lane's columns
// never change: the ring's out-of-range slots are filled with +inf once, a
// refill is row y + D of the same columns, and the lane's pointers advance
// by a row. Otherwise the (strip, row) task stream of `advance`.
template <int kDelta, bool kLeft, bool kRig, bool kOneStrip>
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

#include "strip_sweep.inc"
}

using Kernel = void (*)(Params);

template <int kDelta, bool kOneStrip>
Kernel pick(bool left, bool rig) {
  if (left)
    return rig ? dp_strips_kernel<kDelta, true, true, kOneStrip>
               : dp_strips_kernel<kDelta, true, false, kOneStrip>;
  return rig ? dp_strips_kernel<kDelta, false, true, kOneStrip>
             : dp_strips_kernel<kDelta, false, false, kOneStrip>;
}

template <bool kOneStrip>
Kernel kernel_for(int delta, bool left, bool rig) {
  switch (delta) {
    case 0: return pick<0, kOneStrip>(left, rig);
    case 1: return pick<1, kOneStrip>(left, rig);
    case 2: return pick<2, kOneStrip>(left, rig);
    case 3: return pick<3, kOneStrip>(left, rig);
    default: return pick<-1, kOneStrip>(left, rig);
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
