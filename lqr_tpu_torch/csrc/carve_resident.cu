// Resident multi-seam carve for one map, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lqr_tpu/ops/carve_resident.py:_kernel
// (launched by carve_chunk_resident). One launch carves kc <= KC seams off
// the compacted planes; per seam j, at width w = w0 - j and global 1-based
// seam index s = d0 + j + 1:
//
//   1. the side preference of s (SPEC.md §5): LEFT iff ssf <= 0 or
//      (s - 1) / ssf is even;
//   2. a forward sweep, row by row: the energy row from reader rows y-1, y,
//      y+1 in the op order of core/energy.py (SPEC.md §2), plus the bias,
//      +inf at x >= w; then the DP cell rule of seam_dp.cuh; bp goes to an
//      int8 scratch;
//   3. the start column: the minimum of the last DP row, at its leftmost
//      (LEFT) or rightmost (RIGHT) column;
//   4. the chase x_{y-1} = x_y + bp[y, x_y] into seam[];
//   5. the record hist[j, y] = posmap[y, seam[y]], a reference column;
//   6. the compaction a[y, x] <- a[y, x + 1] for seam[y] <= x < w - 1 of b,
//      posmap, and bias and rig where present. Columns x >= w - 1 are left
//      as they are: nothing reads them at the narrower width.
//
// After the last seam every plane is zeroed at x >= w0 - kc, so the planes
// end equal to those of kc per-seam steps (core/engine.py zeroes at every
// step). None of the TPU layout is carried over: no [f, 128] folds, no
// wedges, no one-hot chase, no SMEM scalars.
//
// The batched entry (lqr_carve_resident_batched) carves one chunk for every
// map of a [B, H, Wb] batch in one launch, one thread block per map, each
// with its own w0, d0, kc, true height h and rigc row. It replaces the JAX
// package's "scan the batch through the solo engine" tier
// (lqr_tpu/parallel/batch.py:71-88): the batch is the grid, so up to 132
// SMs work instead of one. Ragged rows follow lqr_tpu/core/dp.py:90-93 and
// core/energy.py:90-93: the bottom edge replicates at row h - 1, the sweep
// stops there (rows >= h would pass the frontier through), the chase starts
// at row h - 1, and rows >= h carry seam[h - 1] through the record and the
// compaction, as the JAX ragged DP leaves them. A map with kc = 0 carves
// nothing and is only zeroed at x >= w0, as kc per-seam steps leave it.
//
// Design: one thread block, persistent across the chunk; up to 1024
// threads stride over the columns, ITEMS columns each. The planes stay in
// global memory: at the sizes ops/carve_resident.py:resident_ok admits
// (<= 20 MiB) they stay in the 50 MB L2 for the whole chunk. The DP
// frontier is double-buffered in shared memory. Each thread loads its
// inputs of row y + 1 before it computes row y, so those loads are in
// flight during the row's work and its barrier. The chase runs on one
// thread. The compaction gives each row to one warp, which walks it in
// ascending groups of kUnroll * 32 columns: every lane loads the group
// before a __syncwarp() and stores it after, so no store overwrites a
// column that another lane has still to read.
//
// What bounds it on this card: one SM of 132 does all the work (per map:
// the batched entry puts B maps on up to 132 SMs, where their planes no
// longer fit the L2 together and stream from device memory). Per seam,
// the forward sweep is a serial chain of H rows, each a block-wide barrier
// after every thread's serial chain for its columns (energy branches on a
// run-time family, dp_best's loop over a run-time number of candidates):
// on the H100 the time per seam grows with the columns each thread owns
// (1024 threads are fastest; 128 threads take 3.1x as long at 1024x768),
// so operations and their latency bound it, not the planes' bytes. The
// chase adds a serial chain of H dependent L2 loads on one thread. What
// the design does about it: nothing yet beyond the one-row prefetch. A
// later change would make delta_x = 1 and the energy family compile-time
// (an unrolled three-candidate min), chase with a warp that loads a window
// of bp rows ahead of the walk, split each row over a thread-block cluster
// exchanging halo columns through distributed shared memory, or carve
// several maps per launch (one block each).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "energy.cuh"
#include "seam_dp.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDelta = 10;
constexpr int kMaxItems = 8;        // columns per thread: Wb <= 8192
constexpr int kUnroll = 4;          // compaction: 32-column chunks per group

template <int ITEMS, bool kBatched>
__global__ void __launch_bounds__(kMaxThreads)
carve_resident_kernel(float* b, float* bias, float* rig, int* pm,
                      int8_t* bp, int* seam, int* hist,
                      const float* rigc_in, const int* params, int H, int Wb,
                      int w0, int d0, int kc, int KC, int delta_x, int nrg,
                      int ssf) {
  extern __shared__ float frontier[];       // 2 * Wb
  __shared__ float rigc[kMaxDelta + 1];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = nt >> 5;
  const int fam = nrg == 6 ? kNull : nrg % 3;
  const bool has_bias = bias != nullptr;
  const bool has_rig = rig != nullptr;

  // this block's map: in the batched entry, its params row [w0, d0, kc,
  // h] and its slices of the batch; in the solo entry, the arguments and
  // h = H (a separate instantiation, so the solo kernel carries none of
  // this: with it the solo kernel ran 10 % slower on the H100)
  int h = H;
  if (kBatched) {
    const int img = blockIdx.x;
    w0 = params[4 * img];
    d0 = params[4 * img + 1];
    kc = params[4 * img + 2];
    h = params[4 * img + 3];
    const size_t plane = (size_t)img * H * Wb;
    b += plane;
    pm += plane;
    bp += plane;
    if (has_bias) bias += plane;
    if (has_rig) rig += plane;
    seam += (size_t)img * H;
    hist += (size_t)img * KC * H;
    rigc_in += (size_t)img * (delta_x + 1);
  }

  if (t <= delta_x) rigc[t] = rigc_in[t];
  for (int i = t; i < (KC - kc) * H; i += nt) hist[(size_t)kc * H + i] = -1;
  __syncthreads();

  for (int j = 0; j < kc; ++j) {
    const int w = w0 - j;
    const int s = d0 + j + 1;
    const bool left = ssf <= 0 || ((s - 1) / ssf) % 2 == 0;

    // ---- forward sweep; rows y + 1's inputs load while row y computes
    float* prev = frontier;
    float* cur = frontier + Wb;
    Px nxt[ITEMS] = {};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = t + i * nt;
      if (x < w) load_px(nxt[i], b, bias, rig, fam, 0, x, h, Wb, w);
    }
    for (int y = 0; y < h; ++y) {
      Px px[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) px[i] = nxt[i];
      if (y + 1 < h) {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const int x = t + i * nt;
          if (x < w) load_px(nxt[i], b, bias, rig, fam, y + 1, x, h, Wb, w);
        }
      }
      int8_t* bp_row = bp + (size_t)y * Wb;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int x = t + i * nt;
        if (x >= Wb) continue;
        if (x >= w) {
          cur[x] = INFINITY;
          continue;
        }
        const float e = energy(px[i], fam, has_bias);
        if (y == 0) {
          cur[x] = e;
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

    // ---- start column: minimum of the last row, then its leftmost
    // (LEFT) or rightmost (RIGHT) column; columns >= w hold +inf
    float v = INFINITY;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = t + i * nt;
      if (x < w) v = fminf(v, prev[x]);
    }
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
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int x = t + i * nt;
      if (x < w && prev[x] == m) idx = left ? min(idx, x) : max(idx, x);
    }
    idx = warp_pick(idx, left);
    if (lane == 0) red_i[warp] = idx;
    __syncthreads();

    // ---- the chase, on one thread, from row h - 1; rows >= h carry its
    // start, as pass-through rows (bp = 0) would
    if (t == 0) {
      int x = red_i[0];
      for (int k = 1; k < nwarps; ++k)
        x = left ? min(x, red_i[k]) : max(x, red_i[k]);
      for (int y = H - 1; y >= h; --y) seam[y] = x;
      for (int y = h - 1; y > 0; --y) {
        seam[y] = x;
        x += bp[(size_t)y * Wb + x];
      }
      seam[0] = x;
    }
    __syncthreads();

    // ---- record and compaction, one warp per row
    for (int y = warp; y < H; y += nwarps) {
      const int sx = seam[y];
      const size_t row = (size_t)y * Wb;
      // lane 0 alone reads and later overwrites pm[row + sx]: no sync needed
      if (lane == 0) hist[(size_t)j * H + y] = pm[row + sx];
      for (int x0 = sx; x0 < w - 1; x0 += 32 * kUnroll) {
        float vb[kUnroll], vbias[kUnroll], vrig[kUnroll];
        int vpm[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t x = x0 + u * 32 + lane;
          if (x < (size_t)(w - 1)) {
            vb[u] = b[row + x + 1];
            vpm[u] = pm[row + x + 1];
            if (has_bias) vbias[u] = bias[row + x + 1];
            if (has_rig) vrig[u] = rig[row + x + 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t x = x0 + u * 32 + lane;
          if (x < (size_t)(w - 1)) {
            b[row + x] = vb[u];
            pm[row + x] = vpm[u];
            if (has_bias) bias[row + x] = vbias[u];
            if (has_rig) rig[row + x] = vrig[u];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- zeros at x >= w0 - kc, as the per-seam steps leave them
  const int wf = w0 - kc;
  for (int y = warp; y < H; y += nwarps) {
    const size_t row = (size_t)y * Wb;
    for (int x = wf + lane; x < Wb; x += 32) {
      b[row + x] = 0.0f;
      pm[row + x] = 0;
      if (has_bias) bias[row + x] = 0.0f;
      if (has_rig) rig[row + x] = 0.0f;
    }
  }
}

template <int ITEMS, bool kBatched>
int launch(int blocks, int threads, size_t smem, cudaStream_t stream,
           float* b, float* bias, float* rig, int* pm, int8_t* bp, int* seam,
           int* hist, const float* rigc, const int* params, int H, int Wb,
           int w0, int d0, int kc, int KC, int delta_x, int nrg, int ssf) {
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        carve_resident_kernel<ITEMS, kBatched>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  carve_resident_kernel<ITEMS, kBatched><<<blocks, threads, smem, stream>>>(
      b, bias, rig, pm, bp, seam, hist, rigc, params, H, Wb, w0, d0, kc, KC,
      delta_x, nrg, ssf);
  return (int)cudaGetLastError();
}

template <bool kBatched>
int dispatch(int blocks, cudaStream_t st, float* b, float* bias, float* rig,
             int* pm, int8_t* bp, int* seam, int* hist, const float* rigc,
             const int* params, int H, int Wb, int w0, int d0, int kc, int KC,
             int delta_x, int nrg, int ssf) {
  const int threads = Wb < kMaxThreads ? ((Wb + 31) / 32) * 32 : kMaxThreads;
  const int items = (Wb + threads - 1) / threads;
  const size_t smem = (size_t)2 * Wb * sizeof(float);
#define LQR_LAUNCH(N)                                                      \
  launch<N, kBatched>(blocks, threads, smem, st, b, bias, rig, pm, bp,    \
                      seam, hist, rigc, params, H, Wb, w0, d0, kc, KC,   \
                      delta_x, nrg, ssf)
  if (items == 1) return LQR_LAUNCH(1);
  if (items == 2) return LQR_LAUNCH(2);
  if (items <= 4) return LQR_LAUNCH(4);
  return LQR_LAUNCH(8);
#undef LQR_LAUNCH
}

bool bad_shape(int H, int Wb, int KC, int delta_x, int nrg) {
  return H < 1 || Wb < 1 || Wb > kMaxThreads * kMaxItems || KC < 1 ||
         delta_x < 0 || delta_x > kMaxDelta || nrg < 0 || nrg > 6;
}

}  // namespace

extern "C" {

// b, bias, rig: [H, Wb] f32, carved in place (bias and rig may be null);
// pm: [H, Wb] i32 posmap, carved in place; bp: [H, Wb] int8 and seam: [H]
// i32 scratch; hist: [KC, H] i32 out (rows >= kc set to -1); rigc:
// [delta_x + 1] f32 on the device. Launches on `stream` and returns the
// launch's cudaError_t (0 on success), clearing it.
int lqr_carve_resident(float* b, float* bias, float* rig, int* pm,
                       int8_t* bp, int* seam, int* hist, const float* rigc,
                       int H, int Wb, int w0, int d0, int kc, int KC,
                       int delta_x, int nrg, int ssf, void* stream) {
  if (bad_shape(H, Wb, KC, delta_x, nrg) || kc < 0 || kc > KC || kc > w0 ||
      w0 > Wb || d0 < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(1, (cudaStream_t)stream, b, bias, rig, pm, bp, seam,
                         hist, rigc, nullptr, H, Wb, w0, d0, kc, KC, delta_x,
                         nrg, ssf);
}

// The batched entry: every plane (and bp) is [B, H, Wb], seam [B, H], hist
// [B, KC, H], rigc [B, delta_x + 1] f32, params [B, 4] i32 on the device,
// one row [w0, d0, kc, h] per map (0 <= kc <= min(KC, w0), w0 <= Wb,
// d0 >= 0, 1 <= h <= H; the caller checks them). One thread block per map.
int lqr_carve_resident_batched(float* b, float* bias, float* rig, int* pm,
                               int8_t* bp, int* seam, int* hist,
                               const float* rigc, const int* params, int B,
                               int H, int Wb, int KC, int delta_x, int nrg,
                               int ssf, void* stream) {
  if (bad_shape(H, Wb, KC, delta_x, nrg) || B < 1 || params == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(B, (cudaStream_t)stream, b, bias, rig, pm, bp, seam,
                        hist, rigc, params, H, Wb, 0, 0, 0, KC, delta_x, nrg,
                        ssf);
}

}  // extern "C"
