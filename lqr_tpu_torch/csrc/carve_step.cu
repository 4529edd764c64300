// One fused seam step on the reader plane, CUDA C++ for sm_90a: two
// kernels, each one launch per seam.
//
// dp_energy_forward replaces the Pallas TPU kernel
// lqr_tpu/ops/dp_pallas.py:_dpef_kernel (launched by carve_step_pallas with
// fuse_energy=True): the forward seam DP with the energy computed inline
// from the reader plane b [H, Wb] instead of read from an energy map:
//
//   E[y, x] = energy(b rows y-1, y, y+1 at x-1, x, x+1) (+ bias[y, x])  x < w
//           = +inf                                                       x >= w
//   M[0, x] = E[0, x]; M[y, x] = E[y, x] + min_dx(M[y-1, x+dx] + rig*rigc)
//
// with the energy of energy.cuh (edges replicated at lane 0, lane w - 1,
// row 0 and row H - 1; NULL gives 0) and the cell rule of seam_dp.cuh, so
// M_last [Wb] and bp [H, Wb] equal those of dp_forward.cu run on
// core/energy.py's energy map, at every lane.
//
// backtrack_compact replaces :_btcf_kernel (any delta_x) and :_btwc_kernel
// (delta_x = 1, the wedge chase), launched by carve_step_pallas after
// either forward kernel: the start column x_H = argmin M_last (leftmost
// when the side preference is LEFT, else rightmost), the chase
// x_{y-1} = x_y + bp[y, x_y] into seam [H], and the compaction of b, and of
// bias and rig where present, into fresh planes:
//
//   out[y, x] = x < w - 1 ? (x >= seam[y] ? a[y, x + 1] : a[y, x]) : 0
//
// (the roll/select law of core/engine.py). None of the TPU layout is
// carried over: no [f, 128] folds, no wedges, no one-hot walk, no cyclic
// log-reduction of the seam index, no SMEM scalars.
//
// Design. dp_energy_forward is dp_forward.cu's one thread block with the
// frontier double-buffered in shared memory (Wb up to about 29 000 lanes on
// an H100; the wrapper refuses wider maps), with the resident kernel's
// one-row prefetch: each thread loads row y + 1's reader, bias and rig
// values for its ITEMS columns before it computes row y. backtrack_compact
// runs one thread block per kRows rows with no grid-wide barrier: every
// block reduces M_last itself (Wb floats), chases from row H - 1 up to its
// own first row on one thread, writes its rows of seam, and compacts its
// rows with the whole block, reading the old planes and writing new ones.
// The chases run side by side; the longest (the block of row 0) is the one
// chase a single-block backtrack would do.
//
// What bounds them on this card. The forward sweep is a serial chain of H
// rows, each a block-wide barrier after every thread's serial chain for its
// columns (the energy's branches on a run-time family, dp_best's loop over a
// run-time number of candidates), on one SM of 132: operations and their
// latency, not bytes (b is 16.8 MB at 2048^2, read once); the energy in
// each thread's chain makes a row cost more than dp_forward.cu's. The
// backtrack is a chain of H dependent one-byte L2 loads on one thread
// (block 0's, slower than a lone chase while the other blocks chase the
// same path and compact); the compaction (2 x 16.8 MB per plane at 2048^2)
// spreads over H / kRows blocks and is small beside it. What the design
// does about it: nothing yet beyond the prefetch and the spread
// compaction; see csrc/dp_forward.cu and csrc/carve_resident.cu for what a
// later change would try.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "energy.cuh"
#include "seam_dp.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDelta = 10;
constexpr int kMaxItems = 32;       // columns per thread: Wb <= 32768
constexpr int kBtThreads = 256;     // backtrack_compact: threads per block
constexpr int kRows = 16;           // backtrack_compact: rows per block

// Row y's inputs of column x: load_px's below the width; only the rigidity
// at and past it, where the DP still picks a backpointer over +inf energy.
__device__ __forceinline__ void load_col(Px& p, const float* b,
                                         const float* bias, const float* rig,
                                         int fam, int y, int x, int H, int Wb,
                                         int w) {
  if (x < w)
    load_px(p, b, bias, rig, fam, y, x, H, Wb, w);
  else if (rig && x < Wb)
    p.rig = rig[(size_t)y * Wb + x];
}

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
dp_energy_forward_kernel(const float* __restrict__ b,
                         const float* __restrict__ bias,
                         const float* __restrict__ rig,
                         const float* __restrict__ rigc_in, int pref_left,
                         int delta_x, int nrg, int H, int Wb, int w,
                         float* __restrict__ m_last,
                         int8_t* __restrict__ bp) {
  extern __shared__ float frontier[];       // 2 * Wb
  __shared__ float rigc[kMaxDelta + 1];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int fam = nrg == 6 ? kNull : nrg % 3;
  const bool has_bias = bias != nullptr;
  const bool has_rig = rig != nullptr;
  const bool left = pref_left != 0;

  if (t <= delta_x) rigc[t] = rigc_in[t];
  float* prev = frontier;
  float* cur = frontier + Wb;
  Px nxt[ITEMS] = {};
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    load_col(nxt[i], b, bias, rig, fam, 0, t + i * nt, H, Wb, w);
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    Px px[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) px[i] = nxt[i];
    if (y + 1 < H) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        load_col(nxt[i], b, bias, rig, fam, y + 1, t + i * nt, H, Wb, w);
    }
    int8_t* bp_row = bp + (size_t)y * Wb;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = t + i * nt;
      if (x >= Wb) continue;
      const float e = x < w ? energy(px[i], fam, has_bias) : INFINITY;
      if (y == 0) {
        cur[x] = e;
        bp_row[x] = 0;
        continue;
      }
      int best_dx;
      const float best = dp_best(prev, x, Wb, px[i].rig, has_rig, rigc,
                                 delta_x, left, &best_dx);
      cur[x] = __fadd_rn(e, best);
      bp_row[x] = (int8_t)best_dx;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  for (int x = t; x < Wb; x += nt) m_last[x] = prev[x];
}

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

template <int ITEMS>
int launch_forward(int threads, size_t smem, cudaStream_t stream,
                   const float* b, const float* bias, const float* rig,
                   const float* rigc, int pref_left, int delta_x, int nrg,
                   int H, int Wb, int w, float* m_last, int8_t* bp) {
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_energy_forward_kernel<ITEMS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  dp_energy_forward_kernel<ITEMS><<<1, threads, smem, stream>>>(
      b, bias, rig, rigc, pref_left, delta_x, nrg, H, Wb, w, m_last, bp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// b, bias, rig: [H, Wb] f32 (bias and rig may be null); rigc: [delta_x + 1]
// f32 on the device; 1 <= w <= Wb; nrg 0..6; m_last: [Wb] f32; bp: [H, Wb]
// int8. Launches on `stream` and returns the launch's cudaError_t (0 on
// success), clearing it; a frontier too large for the opt-in shared memory
// is refused by cudaFuncSetAttribute.
int lqr_dp_energy_forward(const float* b, const float* bias, const float* rig,
                          const float* rigc, int pref_left, int delta_x,
                          int nrg, int H, int Wb, int w, float* m_last,
                          int8_t* bp, void* stream) {
  if (H < 1 || Wb < 1 || Wb > kMaxThreads * kMaxItems || w < 1 || w > Wb ||
      delta_x < 0 || delta_x > kMaxDelta || nrg < 0 || nrg > 6)
    return (int)cudaErrorInvalidValue;
  const int threads = Wb < kMaxThreads ? ((Wb + 31) / 32) * 32 : kMaxThreads;
  const int items = (Wb + threads - 1) / threads;
  const size_t smem = (size_t)2 * Wb * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define LQR_LAUNCH(N)                                                      \
  launch_forward<N>(threads, smem, st, b, bias, rig, rigc, pref_left,     \
                    delta_x, nrg, H, Wb, w, m_last, bp)
  if (items == 1) return LQR_LAUNCH(1);
  if (items == 2) return LQR_LAUNCH(2);
  if (items <= 4) return LQR_LAUNCH(4);
  if (items <= 8) return LQR_LAUNCH(8);
  if (items <= 16) return LQR_LAUNCH(16);
  return LQR_LAUNCH(32);
#undef LQR_LAUNCH
}

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
