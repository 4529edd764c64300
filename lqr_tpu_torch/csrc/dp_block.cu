// One halo-extended block of forward-DP rows for the column-sharded resize,
// CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lqr_tpu/ops/dp_block.py:_dpb_kernel
// (launched by dp_block_pallas). Between two halo exchanges a shard of the
// column-sharded DP (parallel/sharding.py) advances R rows on its slab
// extended by G = R * delta_x columns of each neighbour:
//
//   M[-1] = m0                          (the exchanged frontier, [We])
//   M[0]  = E[0], bp[0] = 0             if `first` (the block holds the
//                                       image's row 0, which has no
//                                       predecessor)
//   M[y]  = E[y] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig[y, x] * rigc[|dx|] )
//
// with +inf outside [0, We) and the cell rule of seam_dp.cuh (the first
// candidate in the side preference's rank order that equals the minimum).
// Outputs: m_out = M[R-1] [We] f32 and bp [R, We] int8. Lanes whose cone
// reaches the slab's edge within R rows are upper bounds; the shard's own
// columns, G lanes in from either edge, are exact.
//
// None of the TPU layout is carried over: no [f, 128] fold of the row, no
// CH-row int8 stores, no padding of We to a multiple of 128 (all three were
// Mosaic constraints, lqr_tpu/ops/dp_block.py:11-15 and
// lqr_tpu/parallel/sharding.py:214-226); We is any width.
//
// Design: one thread block; up to 1024 threads stride over the We
// columns; the frontier pair in shared memory (2 * We * 4 bytes), or, when
// that pair exceeds the opt-in shared memory, in a [2, We] f32 global
// scratch the caller passes, which the block's own L1 serves; one
// __syncthreads() per row. Either way We is any width.
//
// What bounds it on this card: launch and row latency. At the 2048^2
// shard width on 4 shards (We = 512 + 2 * 32), R = 32 rows are 32 barrier
// steps of one load and one cell per thread, a few tens of microseconds,
// on one SM; a loop that launches one block per (shard, row block, image)
// is bound by the host's launch rate before the kernel. Where it runs:
// on meshes whose column shards lie on distinct devices, or number more
// than a cluster's 8 on one (parallel/sharding.py:dp_route), one launch
// per block of rows and shard: the form that crosses devices. Up to 8
// shards that share one CUDA device take dp_sharded.cu instead: one
// cluster launch a seam over every shard and row block, the halos through
// distributed shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seam_dp.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

// R rows of the slab over the frontier pair `frontier` ([2, We]: shared
// memory, or the global scratch of a wide slab)
__device__ __forceinline__ void dp_block_rows(
    float* frontier, const float* __restrict__ m0,
    const float* __restrict__ e, const float* __restrict__ rig,
    const float* __restrict__ rigc, int pref_left, int first, int delta_x,
    int R, int We, float* __restrict__ m_out, int8_t* __restrict__ bp) {
  float* prev = frontier;
  float* cur = frontier + We;
  const bool left = pref_left != 0;

  int y0 = 0;
  if (first) {
    for (int x = threadIdx.x; x < We; x += blockDim.x) {
      prev[x] = e[x];
      bp[x] = 0;
    }
    y0 = 1;
  } else {
    for (int x = threadIdx.x; x < We; x += blockDim.x) prev[x] = m0[x];
  }
  __syncthreads();

  for (int y = y0; y < R; ++y) {
    const float* e_row = e + (size_t)y * We;
    const float* rig_row = rig ? rig + (size_t)y * We : nullptr;
    int8_t* bp_row = bp + (size_t)y * We;
    for (int x = threadIdx.x; x < We; x += blockDim.x) {
      const float r = rig_row ? rig_row[x] : 0.0f;
      int best_dx;
      const float best = dp_best(prev, x, We, r, rig_row != nullptr, rigc,
                                 delta_x, left, &best_dx);
      cur[x] = __fadd_rn(e_row[x], best);
      bp_row[x] = (int8_t)best_dx;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  for (int x = threadIdx.x; x < We; x += blockDim.x) m_out[x] = prev[x];
}

__global__ void dp_block_kernel(const float* __restrict__ m0,
                                const float* __restrict__ e,
                                const float* __restrict__ rig,
                                const float* __restrict__ rigc,
                                int pref_left, int first, int delta_x, int R,
                                int We, float* __restrict__ m_out,
                                int8_t* __restrict__ bp) {
  extern __shared__ float frontier[];
  dp_block_rows(frontier, m0, e, rig, rigc, pref_left, first, delta_x, R, We,
                m_out, bp);
}

// The same rows with the frontier pair in a global scratch
__global__ void dp_block_wide_kernel(const float* __restrict__ m0,
                                     const float* __restrict__ e,
                                     const float* __restrict__ rig,
                                     const float* __restrict__ rigc,
                                     int pref_left, int first, int delta_x,
                                     int R, int We, float* __restrict__ m_out,
                                     int8_t* __restrict__ bp,
                                     float* __restrict__ scratch) {
  dp_block_rows(scratch, m0, e, rig, rigc, pref_left, first, delta_x, R, We,
                m_out, bp);
}

}  // namespace

extern "C" {

// m0: [We] f32 (read unless `first`); e, rig: [R, We] f32 (rig may be
// null); rigc: [delta_x + 1] f32 on the device; m_out: [We] f32; bp:
// [R, We] int8; scratch: null, or [2 * We] f32 on the device to hold the
// frontier pair when 2 * We * 4 bytes exceed the opt-in shared memory.
// Launches on `stream` and returns the launch's cudaError_t (0 on success),
// clearing it.
int lqr_dp_block(const float* m0, const float* e, const float* rig,
                 const float* rigc, int pref_left, int first, int delta_x,
                 int R, int We, float* m_out, int8_t* bp, float* scratch,
                 void* stream) {
  if (R < 1 || We < 1 || delta_x < 0 || delta_x > 63 ||
      (!first && m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = We < kMaxThreads ? ((We + 31) / 32) * 32 : kMaxThreads;
  if (scratch) {
    dp_block_wide_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        m0, e, rig, rigc, pref_left, first, delta_x, R, We, m_out, bp,
        scratch);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)2 * We * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  dp_block_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      m0, e, rig, rigc, pref_left, first, delta_x, R, We, m_out, bp);
  return (int)cudaGetLastError();
}

}  // extern "C"
