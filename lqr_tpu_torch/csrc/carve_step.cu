// The fused seam step's second kernel, CUDA C++ for sm_90a, one launch
// per seam: backtrack_compact. The step's forward DP with the energy
// inline is dp_energy_forward.cu's kernel.
//
// backtrack_compact replaces lqr_tpu/ops/dp_pallas.py:_btcf_kernel (any
// delta_x) and :_btwc_kernel (delta_x = 1, the wedge chase), launched by
// carve_step_pallas after either forward kernel: the start column x_H =
// argmin M_last (leftmost when the side preference is LEFT, else
// rightmost), the chase x_{y-1} = x_y + bp[y, x_y] into seam [H], and the
// compaction of b, and of bias and rig where present, into fresh planes:
//
//   out[y, x] = x < w - 1 ? (x >= seam[y] ? a[y, x + 1] : a[y, x]) : 0
//
// (the roll/select law of core/engine.py). None of the TPU layout is
// carried over: no [f, 128] folds, no wedges, no one-hot walk, no cyclic
// log-reduction of the seam index, no SMEM scalars.
//
// Design: one chase a launch, the compaction over the whole card behind it.
// Every block takes a ticket from a counter. Ticket 0 makes its block the
// chaser: the block reduces M_last to the start column in one pass of
// (value, column) pairs, and its warp 0 runs the windowed chase of
// chase.cuh. After each window's seam rows are stored, the chasing warp
// hands off to warp 1 of its block that every row >= y is in seam[]
// (__syncwarp, __threadfence_block, a shared store from lane 0), and warp 1,
// the publisher, makes it public: __threadfence, then a release store of the
// progress word (windows handed off meanwhile go in one store). So the
// device-scope fence, which waits for the window's stores to reach the L2,
// is off the chase's chain: on the chasing warp itself it costs 0.64 us a
// window, 41 us at 2048^2 (tools/btc_variants.py; H100 80GB HBM3, 700 W).
// Ticket k >= 1 is a band of kBand rows by kSeg columns, bands from the last
// row upward (the order in which the chase publishes them), the segments of
// a band next to each other: its block waits on the progress word (an
// acquire load, __nanosleep backoff), reads the band's seam rows past the L1
// (__ldcg: they were written in this launch) and compacts them, a warp a
// row. No pointer the launch writes is __restrict__ or read through __ldg
// (the guard of every kernel here, chase.cuh). Where Wb % 4 == 0 and every
// plane is 16-byte aligned, a lane owns 4 output columns: it loads the
// aligned vector at x, takes a[y, x + 4] from its neighbour lane (the edge
// lane loads it), selects per column against seam[y] and stores 16 bytes;
// otherwise a scalar path of the same kernel. Stores are the default
// (L2-resident) ones: the next seam's forward kernel reads the planes again.
//
// No deadlock: the only block any block waits on is the chaser, and the
// chaser took ticket 0 while it was running, so it runs to its end whatever
// else is on the card; the grid (a block a ticket) needs no co-residency,
// since a block that waits holds a ticket taken after the chaser's. No stale
// progress: the wrapper passes a per-launch epoch, counted per (device,
// stream) with the two words of device scratch that it keeps for that
// stream, and both words carry it in their upper 32 bits. Each block first
// raises the ticket word to epoch << 32 (atomicMax: a no-op once this
// launch's first block has), so an earlier launch's count is never handed
// out; the progress word holds epoch << 32 | rows published, and a waiter
// wants at least epoch << 32 | rows of its band, which no earlier launch's
// word (a smaller epoch) can satisfy. This holds after a launch that failed
// or never ran (its epoch is simply skipped) and for launches on two streams
// at once (separate scratch). An epoch taken at capture would repeat at
// every replay of a CUDA graph, so the wrapper refuses capture.
//
// What bounds it on this card: the chase, a serial chain of H dependent
// steps; the compaction's bytes (2 x 16.8 MB a plane at 2048^2, ~0.01 ms at
// HBM speed) run behind it, and only the last window's bands (kBand rows
// by kSeg columns a block) are compacted after it. At 2048^2, delta_x = 1
// (H100 80GB HBM3, 700 W): 0.066 ms without masks, 0.079 ms with bias and
// rig, of which the chase in this kernel is 0.063 ms (backtrack.cu's:
// 0.060).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chase.cuh"

namespace {

constexpr int kThreads = 256;       // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBand = kWarps;       // rows of a band, a warp a row
constexpr int kSeg = 512;           // columns of a band's segment
constexpr int kGroup = 4;           // 16-byte vectors in flight a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The chase's hand-off to its block's publisher warp: every row >= y is
// in seam[] (a release at block scope: the warp's stores, then the row).
struct Handoff {
  volatile int* rows;
  __device__ __forceinline__ void rows_from(int y, int lane) const {
    __syncwarp();
    __threadfence_block();
    if (lane == 0) *rows = max(y, 0);
  }
};

// The publisher warp: each row the chase hands off goes to the progress
// word (an acquire at block scope, __threadfence, a release store at device
// scope), windows handed off meanwhile in one store; until row 0.
__device__ __forceinline__ void publish(volatile int* rows,
                                       unsigned long long* progress,
                                       unsigned long long tag, int H,
                                       int lane) {
  int done = H;
  while (done > 0) {
    const int y = *rows;
    if (y >= done) {
      __nanosleep(32);
      continue;
    }
    __threadfence_block();
    __threadfence();
    if (lane == 0) st_release(progress, tag | (unsigned)(H - y));
    done = y;
  }
}

// Columns [c0, c1) of row y of one plane, compacted along seam column s
// (a warp; c0 a multiple of 4 on the vector path).
template <bool kVec>
__device__ __forceinline__ void compact_row(const float* __restrict__ a,
                                            float* out, int y, int s,
                                            int Wb, int w, int c0, int c1,
                                            int lane) {
  const float* src = a + (size_t)y * Wb;
  float* dst = out + (size_t)y * Wb;
  const int keep = w - 1;           // columns x < keep hold a value
  if constexpr (kVec) {
    for (int base = c0; base < c1; base += 128 * kGroup) {
      float4 v[kGroup];
      float edge[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        // columns up to w - 1 are sources; a[y, x + 4] comes from the next
        // lane, or from its own load where that lane holds no vector of
        // this group
        const int x = base + 128 * g + 4 * lane;
        v[g] = x < c1 && x < w ? *reinterpret_cast<const float4*>(src + x)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const bool last = lane == 31 || x + 4 >= c1;
        edge[g] = x < c1 && last && x + 4 < w ? src[x + 4] : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int x = base + 128 * g + 4 * lane;
        const float down = __shfl_down_sync(kFull, v[g].x, 1);
        const float nx = lane == 31 || x + 4 >= c1 ? edge[g] : down;
        float4 o;
        o.x = x < keep ? (x >= s ? v[g].y : v[g].x) : 0.0f;
        o.y = x + 1 < keep ? (x + 1 >= s ? v[g].z : v[g].y) : 0.0f;
        o.z = x + 2 < keep ? (x + 2 >= s ? v[g].w : v[g].z) : 0.0f;
        o.w = x + 3 < keep ? (x + 3 >= s ? nx : v[g].w) : 0.0f;
        if (x < c1) *reinterpret_cast<float4*>(dst + x) = o;
      }
    }
  } else {
    for (int x = c0 + lane; x < c1; x += 32)
      dst[x] = x < keep ? src[x >= s ? x + 1 : x] : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
backtrack_compact_kernel(const float* __restrict__ m_last,
                         const int8_t* __restrict__ bp,
                         const float* __restrict__ b,
                         const float* __restrict__ bias,
                         const float* __restrict__ rig, int pref_left, int H,
                         int Wb, int w, int* seam, float* b_out,
                         float* bias_out, float* rig_out,
                         unsigned long long* sync, unsigned long long tag) {
  __shared__ __align__(16) int8_t win[2][kRows * kSpan];
  __shared__ float red_v[kWarps];
  __shared__ int red_x[kWarps];
  __shared__ long long s_ticket;
  __shared__ int s_rows;              // the chase's hand-off
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const bool left = pref_left != 0;
  unsigned long long* tickets = sync;
  unsigned long long* progress = sync + 1;

  if (t == 0) {
    atomicMax(tickets, tag);
    s_ticket = (long long)(atomicAdd(tickets, 1ull) - tag);
  }
  __syncthreads();
  const long long k = s_ticket;

  if (k == 0) {
    // ---- the chaser: the start column over the whole block, then the
    // windowed chase on warp 0, published window by window by warp 1
    float bv = INFINITY;
    int bx = left ? Wb : -1;
    for (int x = t; x < Wb; x += kThreads) {
      const float v = m_last[x];
      if (better(v, x, bv, bx, left)) {
        bv = v;
        bx = x;
      }
    }
    warp_best(bv, bx, left);
    if (lane == 0) {
      red_v[warp] = bv;
      red_x[warp] = bx;
    }
    if (t == 0) s_rows = H;
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : INFINITY;
      bx = lane < kWarps ? red_x[lane] : (left ? Wb : -1);
      warp_best(bv, bx, left);
      Handoff pub;
      pub.rows = &s_rows;
      warp_chase<LdgLoad>(bp, Wb, H - 1, bx, seam, win, lane, pub);
      pub.rows_from(0, lane);   // every row, also after a chase that left
    } else if (warp == 1) {     // the map (bp not from the DP)
      publish(&s_rows, progress, tag, H, lane);
    }
    return;
  }

  // ---- a band: rows [y0, y1) from the bottom, columns [c0, c1)
  const int nseg = (Wb + kSeg - 1) / kSeg;
  const int band = (int)((k - 1) / nseg);
  const int c0 = (int)((k - 1) % nseg) * kSeg;
  const int c1 = min(Wb, c0 + kSeg);
  const int y1 = H - band * kBand;
  const int y0 = max(0, y1 - kBand);
  if (t == 0) {
    const unsigned long long need = tag | (unsigned)(H - y0);
    unsigned ns = 64;
    while (ld_acquire(progress) < need) {
      __nanosleep(ns);
      ns = min(2 * ns, 512u);
    }
    __threadfence();
  }
  __syncthreads();
  const int y = y0 + warp;
  if (y < y1) {
    const int s = __ldcg(seam + y);
    compact_row<kVec>(b, b_out, y, s, Wb, w, c0, c1, lane);
    if (bias) compact_row<kVec>(bias, bias_out, y, s, Wb, w, c0, c1, lane);
    if (rig) compact_row<kVec>(rig, rig_out, y, s, Wb, w, c0, c1, lane);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// m_last: [Wb] f32 (+inf at lanes >= w); bp: [H, Wb] int8; b, bias, rig:
// [H, Wb] f32 (bias and rig may be null, and then so must their outputs);
// 1 <= w <= Wb; seam: [H] i32 out; b_out, bias_out, rig_out: [H, Wb] f32
// out, not aliasing the inputs; sync: the stream's two words of device
// scratch (ticket, progress), zero when first used; epoch: this launch's,
// 1 <= epoch, larger than any earlier launch's on this scratch. Launches
// on `stream` and returns the launch's cudaError_t (0 on success),
// clearing it.
int lqr_backtrack_compact(const float* m_last, const int8_t* bp,
                          const float* b, const float* bias, const float* rig,
                          int pref_left, int H, int Wb, int w, int* seam,
                          float* b_out, float* bias_out, float* rig_out,
                          unsigned long long* sync, unsigned int epoch,
                          void* stream) {
  if (H < 1 || Wb < 1 || w < 1 || w > Wb || sync == nullptr || epoch == 0 ||
      (bias == nullptr) != (bias_out == nullptr) ||
      (rig == nullptr) != (rig_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = Wb % 4 == 0 && aligned16(b) && aligned16(bias) &&
                   aligned16(rig) && aligned16(b_out) &&
                   aligned16(bias_out) && aligned16(rig_out);
  auto kern = vec ? backtrack_compact_kernel<true>
                  : backtrack_compact_kernel<false>;
  // a block a ticket: the chaser and each band of each segment
  const long long grid =
      1 + (long long)((H + kBand - 1) / kBand) * ((Wb + kSeg - 1) / kSeg);
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      m_last, bp, b, bias, rig, pref_left, H, Wb, w, seam, b_out, bias_out,
      rig_out, sync, (unsigned long long)epoch << 32);
  return (int)cudaGetLastError();
}

}  // extern "C"
