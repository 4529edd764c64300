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
// side preference's rank order, whose cost equals the minimum (the cell
// rule of seam_dp.cuh). rigc[m] = f32(m^1.5 / H) comes from the host,
// rounded once from f64.
//
// Design: one thread block per image; up to 1024 threads stride over the
// columns; the frontier M[y-1] / M[y] is double-buffered in shared memory
// (2 * Wb * 4 bytes, 16 KB at Wb = 2048); rows run in order with one
// __syncthreads() between them.
//
// What bounds it on this card: the serial row dependency. Every row costs a
// block-wide barrier plus the latency of its global loads of E (and rig),
// and only one SM of 132 works. At 2048 x 2048 that is 2048 dependent
// barrier+load steps per seam, not bandwidth (E is 16 MB, read once).
// What the design does about it: nothing yet. A later change would
// prefetch the next rows of E into registers or shared memory ahead of the
// barrier (cp.async / TMA), split wide rows over a thread-block cluster
// exchanging halo columns through distributed shared memory, or carve a
// batch of images per launch (one block each). Maps whose planes fit the
// L2 skip this kernel: carve_resident.cu carves a whole chunk of seams in
// one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seam_dp.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void dp_forward_kernel(const float* __restrict__ e,
                                  const float* __restrict__ rig,
                                  const float* __restrict__ rigc,
                                  int pref_left, int delta_x, int H, int Wb,
                                  float* __restrict__ m_last,
                                  int8_t* __restrict__ bp) {
  extern __shared__ float frontier[];
  float* prev = frontier;
  float* cur = frontier + Wb;
  const bool left = pref_left != 0;

  for (int x = threadIdx.x; x < Wb; x += blockDim.x) {
    prev[x] = e[x];
    bp[x] = 0;
  }
  __syncthreads();

  for (int y = 1; y < H; ++y) {
    const float* e_row = e + (size_t)y * Wb;
    const float* rig_row = rig ? rig + (size_t)y * Wb : nullptr;
    int8_t* bp_row = bp + (size_t)y * Wb;
    for (int x = threadIdx.x; x < Wb; x += blockDim.x) {
      const float r = rig_row ? rig_row[x] : 0.0f;
      int best_dx;
      const float best = dp_best(prev, x, Wb, r, rig_row != nullptr, rigc,
                                 delta_x, left, &best_dx);
      cur[x] = __fadd_rn(e_row[x], best);
      bp_row[x] = (int8_t)best_dx;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  for (int x = threadIdx.x; x < Wb; x += blockDim.x) m_last[x] = prev[x];
}

}  // namespace

extern "C" {

// e, rig: [H, Wb] f32 (rig may be null); rigc: [delta_x + 1] f32 on the
// device; m_last: [Wb] f32; bp: [H, Wb] int8. Launches on `stream` and
// returns the launch's cudaError_t (0 on success), clearing it so that it
// does not surface later in an unrelated call.
int lqr_dp_forward(const float* e, const float* rig, const float* rigc,
                   int pref_left, int delta_x, int H, int Wb, float* m_last,
                   int8_t* bp, void* stream) {
  if (H < 1 || Wb < 1 || delta_x < 0 || delta_x > 63)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * Wb * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > (size_t)kDefaultSmem) {
    err = cudaFuncSetAttribute(dp_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const int threads = Wb < kMaxThreads ? ((Wb + 31) / 32) * 32 : kMaxThreads;
  dp_forward_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      e, rig, rigc, pref_left, delta_x, H, Wb, m_last, bp);
  return (int)cudaGetLastError();
}

const char* lqr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
