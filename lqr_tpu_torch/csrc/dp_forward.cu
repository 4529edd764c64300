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
// __syncthreads() between them. A map too wide for the card's opt-in
// shared memory (Wb above about 29 000) keeps the same two frontier rows in
// a global-memory scratch pair that the caller passes in: the same cell
// rule and the same row barrier, which orders the block's global writes
// before the next row's reads as it does for shared memory.
//
// Ragged batches: rows y >= h (the image's true height inside a buffer of
// H rows) are pass-through rows, as in lqr_tpu/core/dp.py:90-93: the
// frontier rides through unchanged and bp = 0, so M_last is row h - 1's.
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

// kGlobal: the frontier pair lives in the caller's global scratch
// (gfront), else in shared memory, so that the shared-memory kernel keeps
// shared-memory addressing. kRagged: h < H; the full-height kernel (every
// solo map) carries no pass-through code, which costs the 2048^2 sweep
// about 1 % on an H100.
template <bool kGlobal, bool kRagged>
__global__ void dp_forward_kernel(const float* __restrict__ e,
                                  const float* __restrict__ rig,
                                  const float* __restrict__ rigc,
                                  int pref_left, int delta_x, int H, int Wb,
                                  int h, float* __restrict__ m_last,
                                  int8_t* __restrict__ bp, float* gfront) {
  extern __shared__ float sfront[];
  // the global scratch is read and written by this block, so neither
  // const nor __restrict__
  float* prev = kGlobal ? gfront : sfront;
  float* cur = prev + Wb;
  const bool left = pref_left != 0;

  for (int x = threadIdx.x; x < Wb; x += blockDim.x) {
    prev[x] = e[x];
    bp[x] = 0;
  }
  __syncthreads();

  const int rows = kRagged ? h : H;
  for (int y = 1; y < rows; ++y) {
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

  // pass-through rows: bp = 0, the frontier unchanged
  if (kRagged)
    for (size_t i = (size_t)h * Wb + threadIdx.x; i < (size_t)H * Wb;
         i += blockDim.x)
      bp[i] = 0;
  for (int x = threadIdx.x; x < Wb; x += blockDim.x) m_last[x] = prev[x];
}

}  // namespace

extern "C" {

// e, rig: [H, Wb] f32 (rig may be null); rigc: [delta_x + 1] f32 on the
// device; h: the true height, 1 <= h <= H (rows >= h pass through);
// m_last: [Wb] f32; bp: [H, Wb] int8; scratch: null, or [2 * Wb] f32 on
// the device to hold the frontier when 2 * Wb * 4 bytes exceed the
// opt-in shared memory (lqr_smem_optin). Launches on `stream` and returns
// the launch's cudaError_t (0 on success), clearing it so that it does
// not surface later in an unrelated call.
int lqr_dp_forward(const float* e, const float* rig, const float* rigc,
                   int pref_left, int delta_x, int H, int Wb, int h,
                   float* m_last, int8_t* bp, float* scratch, void* stream) {
  if (H < 1 || Wb < 1 || h < 1 || h > H || delta_x < 0 || delta_x > 63)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scratch ? 0 : (size_t)2 * Wb * sizeof(float);
  const bool ragged = h < H;
  auto kern = scratch ? (ragged ? dp_forward_kernel<true, true>
                                : dp_forward_kernel<true, false>)
                      : (ragged ? dp_forward_kernel<false, true>
                                : dp_forward_kernel<false, false>);
  cudaError_t err = cudaSuccess;
  if (smem > (size_t)kDefaultSmem) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  const int threads = Wb < kMaxThreads ? ((Wb + 31) / 32) * 32 : kMaxThreads;
  kern<<<1, threads, smem, (cudaStream_t)stream>>>(
      e, rig, rigc, pref_left, delta_x, H, Wb, h, m_last, bp, scratch);
  return (int)cudaGetLastError();
}

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

const char* lqr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
