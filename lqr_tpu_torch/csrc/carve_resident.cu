// Resident multi-seam carve, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lqr_tpu/ops/carve_resident.py:_kernel
// (launched by carve_chunk_resident). One launch carves kc <= KC seams off
// the compacted planes of each map of a batch (a solo map is a batch of
// one); per seam j, at width w = w0 - j and global 1-based seam index
// s = d0 + j + 1:
//
//   1. the side preference of s (SPEC.md §5): LEFT iff ssf <= 0 or
//      (s - 1) / ssf is even (it can switch inside a chunk);
//   2. the energy plus the bias into an E scratch, from reader rows y - 1,
//      y, y + 1 in the op order of core/energy.py (SPEC.md §2, energy.cuh),
//      +inf at x >= w;
//   3. the forward DP over E with the cell rule of seam_dp.cuh; bp goes to
//      an int8 scratch;
//   4. the start column: the minimum of the last DP row, at its leftmost
//      (LEFT) or rightmost (RIGHT) column;
//   5. the chase x_{y-1} = x_y + bp[y, x_y] into seam[];
//   6. the record hist[j, y] = posmap[y, seam[y]], a reference column;
//   7. the compaction a[y, x] <- a[y, x + 1] for seam[y] <= x < w - 1 of b,
//      posmap, and bias and rig where present. Columns x >= w - 1 are left
//      as they are: nothing reads them at the narrower width.
//
// After the last seam every plane is zeroed at x >= w0 - kc, so the planes
// end equal to those of kc per-seam steps (core/engine.py zeroes at every
// step). None of the TPU layout is carried over: no [f, 128] folds, no
// wedges, no one-hot chase, no SMEM scalars.
//
// The entry (lqr_carve_resident_batched) carves one chunk for every map of
// a [B, H, Wp] batch in one launch, one cluster per map, each with its own
// w0, d0, kc, true height h and rigc row. It replaces the JAX
// package's "scan the batch through the solo engine" tier
// (lqr_tpu/parallel/batch.py:71-88). Ragged rows follow
// lqr_tpu/core/dp.py:90-93 and core/energy.py:90-93: the bottom edge
// replicates at row h - 1, the DP stops there (rows >= h would pass the
// frontier through), the chase starts at row h - 1, and rows >= h carry
// seam[h - 1] through the record and the compaction, as the JAX ragged DP
// leaves them. A map with kc = 0 carves nothing and is only zeroed at
// x >= w0, as kc per-seam steps leave it.
//
// Design: one thread-block cluster per map, persistent across the chunk
// (one map: 8 blocks of 8 warps). The cluster is chosen per launch from
// the batch (ops/carve_resident.py:batch_cluster):
// the most warps a map, 8, 4 or 2 blocks of 8 warps or 2 of 4, of which
// the card holds all B clusters at once (lqr_resident_clusters asks it),
// so that a small batch's maps each run their energy pass and compaction
// over several SMs; a batch too large for any (a wave of 256 maps) keeps
// one block of 4 warps per map, all in flight at once, two blocks an SM.
// The kernel finds its map as blockIdx.x / csize whatever the cluster. At
// 255 registers a thread an SM holds one block of 8 warps (15 clusters of
// 8 on an H100); capped at 128 for two (__launch_bounds__(256, 2)) the
// kernel spills ~1 KB a thread and took 1.7-2.3 times as long on an H100
// (the solo 2048x2048 chunk, 16 maps of 1024x1024). The planes (row
// stride Wp, a multiple of 4, 16-byte aligned) stay in global memory. Each
// seam is four phases, each ended by a cluster barrier:
//
//   - the energy pass: every warp of the cluster takes rows x 128-column
//     segments, 4 columns a lane (16-byte loads; the lane's x neighbours by
//     shuffle), eight segments in flight a warp (four for the families
//     with a y gradient, three rows each); E goes to a [H, Wp] f32
//     scratch. It is off the DP's chain: computing the energy inside the
//     row chain lengthens the chain more than it saves in bytes
//     (a one-block dp_energy_forward: 1.69 against 1.33 us/row; the
//     strip sweep with the energy from the reader rows it streams ran the
//     batched cfg4 shape in 27.0 against 24.3 ms on an H100).
//   - the DP: the warp strips of strip_dp.cuh (K-row halos, the E and rig
//     rows through a cp.async ring, the frontier exchanged through
//     distributed shared memory every K rows, the candidate loop unrolled
//     at compile time) on the first `ctas` blocks' first `warps` warps, the
//     geometry from ops/carve_resident.py:resident_geometry. The last row's
//     kept columns go straight into block 0's shared memory.
//   - the start column and the chase on block 0: one pass of (value,
//     column) pairs over that row, a warp shuffle reduction per warp, one
//     over the warps; then warp 0 runs the windowed chase of chase.cuh.
//   - the record and the compaction: two rows at a time to one warp of
//     the cluster, which walks them in ascending groups of kUnroll * 32
//     columns: every lane loads the group (of both rows) before a
//     __syncwarp() and stores it after, so no store overwrites a column
//     that another lane has still to read.
//
// Blocks read what other blocks of the cluster wrote in the same launch,
// so every such read goes past the L1 (ld.global.cg, cp.async.cg) after a
// __threadfence() and a cluster barrier; no plane pointer is __restrict__.
//
// What bounds it on this card: per seam, the DP's chain of h rows (each
// warp's row, ~0.26 us, strip_dp.cuh) and the chase's chain of h steps,
// plus the two passes over the planes (energy, compaction), which run at
// the bandwidth of the cluster's SMs to the L2 (solo) or of device memory
// (a batch whose planes exceed the L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chase.cuh"
#include "energy.cuh"
#include "strip_dp.cuh"

// dp_forward.cu: the opt-in shared memory per block, or a negative error
extern "C" int lqr_smem_optin(void);

namespace {

constexpr int kMaxThreads = 8 * 32;  // 8 warps: up to 255 registers
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSeg = 128;           // energy pass: columns of a warp's unit
constexpr int kUnroll = 8;          // compaction: 32-column chunks per group
constexpr int kRowsAtOnce = 2;      // compaction: rows in flight a warp

// bp read past the L1: other blocks of the cluster wrote it
struct CgLoad {
  static __device__ __forceinline__ uint4 vec(const uint4* p) {
    return __ldcg(p);
  }
  static __device__ __forceinline__ int8_t byte(const int8_t* p) {
    return __ldcg(reinterpret_cast<const signed char*>(p));
  }
};

struct Chunk {
  float* b;
  float* bias;
  float* rig;
  int* pm;
  float* e;              // E scratch [H, Wp]
  int8_t* bp;            // [H, Wp]
  int* seam;             // [H]
  int* hist;             // [KC, H]
  const float* rigc;     // [delta_x + 1] (batched: a row per map)
  const int* params;     // [B, 4] rows [w0, d0, kc, h] (never null)
  int H, Wp, w0, d0, kc, KC, delta, nrg, ssf;
  int ctas, warps, S, G, K;   // the DP's geometry
};

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// The energy pass of one seam: E[y, x] for y < h (the true height), every
// column of Wp, by the cluster's nw warps (this one gw). Unit u: row
// u / nseg, segment u % nseg; a lane's columns x .. x + 3.
// kGy: the family needs the rows above and below (3 loads a unit, 4 units
// in flight a warp); else 8 units in flight: the pass waits on device
// memory, so the bytes in flight set its rate.
template <bool kGy>
__device__ __forceinline__ void energy_pass(const Chunk& c, int h, int w,
                                            int fam, int gw, int nw,
                                            int lane) {
  constexpr int kUnits = kGy ? 4 : 8;
  const int nseg = (c.Wp + kSeg - 1) / kSeg;
  const int total = h * nseg;
  const bool has_bias = c.bias != nullptr;
  for (int u0 = gw * kUnits; u0 < total; u0 += nw * kUnits) {
    float4 mid[kUnits], up[kUnits], dn[kUnits], bs[kUnits];
    float lft[kUnits], rgt[kUnits];
    int xs[kUnits], ys[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + k;
      const int y = u / nseg;
      const int x = (u % nseg) * kSeg + 4 * lane;
      ys[k] = y;
      xs[k] = x;
      const bool in = u < total && x < c.Wp;
      const size_t at = (size_t)y * c.Wp + x;
      mid[k] = up[k] = dn[k] = bs[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      lft[k] = rgt[k] = 0.f;
      if (in && fam != kNull) {
        mid[k] = ldcg4(c.b + at);
        if (lane == 0 && x > 0) lft[k] = __ldcg(c.b + at - 1);
        if (lane == 31 && x + 4 < c.Wp) rgt[k] = __ldcg(c.b + at + 4);
        if constexpr (kGy) {
          up[k] = ldcg4(c.b + (size_t)(y > 0 ? y - 1 : 0) * c.Wp + x);
          dn[k] = ldcg4(c.b + (size_t)(y < h - 1 ? y + 1 : y) * c.Wp + x);
        }
      }
      if (in && has_bias) bs[k] = ldcg4(c.bias + at);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      // the lane's x neighbours: its neighbour lanes', the segment's edge
      // columns loaded above
      const float l0 = __shfl_up_sync(kFull, mid[k].w, 1);
      const float r3 = __shfl_down_sync(kFull, mid[k].x, 1);
      if (u0 + k >= total || xs[k] >= c.Wp) continue;
      const int x = xs[k];
      const float v[6] = {lane == 0 ? lft[k] : l0, mid[k].x, mid[k].y,
                          mid[k].z, mid[k].w, lane == 31 ? rgt[k] : r3};
      const float vu[4] = {up[k].x, up[k].y, up[k].z, up[k].w};
      const float vd[4] = {dn[k].x, dn[k].y, dn[k].z, dn[k].w};
      const float vb[4] = {bs[k].x, bs[k].y, bs[k].z, bs[k].w};
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xi = x + i;
        Px px;
        px.l = xi > 0 ? v[i] : v[i + 1];
        px.r = xi < w - 1 ? v[i + 2] : v[i + 1];
        px.u = vu[i];
        px.d = vd[i];
        px.bias = vb[i];
        px.rig = 0.f;
        out[i] = xi < w ? energy(px, fam, has_bias) : INFINITY;
      }
      *reinterpret_cast<float4*>(c.e + (size_t)ys[k] * c.Wp + x) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

// The record and the compaction of seam j: this warp takes kRowsAtOnce
// rows at a time (rows gw * kRowsAtOnce + r, then + nw * kRowsAtOnce), all
// of their groups' loads in flight together
__device__ __forceinline__ void compact_rows(const Chunk& c, int j, int w,
                                             int gw, int nw, int lane) {
  const bool has_bias = c.bias != nullptr;
  const bool has_rig = c.rig != nullptr;
  constexpr int kGroup = 32 * kUnroll;
  for (int y0 = gw * kRowsAtOnce; y0 < c.H; y0 += nw * kRowsAtOnce) {
    int sx[kRowsAtOnce];
    int groups = 0;
#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) {
      const int y = y0 + r;
      sx[r] = y < c.H ? __ldcg(c.seam + y) : w;
      // lane 0 alone reads and later overwrites pm[row + sx]
      if (lane == 0 && y < c.H)
        c.hist[(size_t)j * c.H + y] =
            __ldcg(c.pm + (size_t)y * c.Wp + sx[r]);
      groups = max(groups, (w - 1 - sx[r] + kGroup - 1) / kGroup);
    }
    for (int g = 0; g < groups; ++g) {
      float vb[kRowsAtOnce][kUnroll], vbias[kRowsAtOnce][kUnroll];
      float vrig[kRowsAtOnce][kUnroll];
      int vpm[kRowsAtOnce][kUnroll];
#pragma unroll
      for (int r = 0; r < kRowsAtOnce; ++r) {
        const size_t row = (size_t)(y0 + r) * c.Wp;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = sx[r] + g * kGroup + u * 32 + lane;
          if (x < w - 1) {
            vb[r][u] = __ldcg(c.b + row + x + 1);
            vpm[r][u] = __ldcg(c.pm + row + x + 1);
            if (has_bias) vbias[r][u] = __ldcg(c.bias + row + x + 1);
            if (has_rig) vrig[r][u] = __ldcg(c.rig + row + x + 1);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowsAtOnce; ++r) {
        const size_t row = (size_t)(y0 + r) * c.Wp;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = sx[r] + g * kGroup + u * 32 + lane;
          if (x < w - 1) {
            c.b[row + x] = vb[r][u];
            c.pm[row + x] = vpm[r][u];
            if (has_bias) c.bias[row + x] = vbias[r][u];
            if (has_rig) c.rig[row + x] = vrig[r][u];
          }
        }
      }
    }
  }
}

// tools/resident_phases.py builds with LQR_RESIDENT_PHASES: block 0's
// thread 0 sums each phase's nanoseconds over the chunk (energy, DP, start
// column and chase, compaction), each phase ending at its barrier
#ifdef LQR_RESIDENT_PHASES
__device__ unsigned long long g_phase_ns[4];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define LQR_PHASE(k)                                      \
  if (blockIdx.x == 0 && threadIdx.x == 0) {              \
    const unsigned long long t = now_ns();                \
    g_phase_ns[k] += t - t_phase;                         \
    t_phase = t;                                          \
  }
#else
#define LQR_PHASE(k)
#endif

__device__ __forceinline__ void sync_cluster(const cg::cluster_group& cl) {
  __threadfence();
  cl.sync();
}

template <int kDelta, bool kRig, bool kOneStrip>
__global__ void __launch_bounds__(kMaxThreads)
    carve_resident_kernel(Chunk c) {
  constexpr int D = ring_depth<kRig>();
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) int8_t win[2][kRows * kSpan];
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_x[kMaxThreads / 32];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gw = rank * nwarps + warp;         // the cluster's warps
  const int nw = csize * nwarps;
  const int fam = c.nrg == 6 ? kNull : c.nrg % 3;

  // this cluster's map: in the batched entry, its params row [w0, d0, kc,
  // h] and its slices of the batch
  int h = c.H;
  if (c.params) {
    const int img = blockIdx.x / csize;
    c.w0 = c.params[4 * img];
    c.d0 = c.params[4 * img + 1];
    c.kc = c.params[4 * img + 2];
    h = c.params[4 * img + 3];
    const size_t plane = (size_t)img * c.H * c.Wp;
    c.b += plane;
    c.pm += plane;
    c.e += plane;
    c.bp += plane;
    if (c.bias) c.bias += plane;
    if (kRig) c.rig += plane;
    c.seam += (size_t)img * c.H;
    c.hist += (size_t)img * c.KC * c.H;
    c.rigc += (size_t)img * (c.delta + 1);
  }

  // shared memory: the DP warps' rings, the frontier pair, M_last
  float* front = smem + (size_t)c.warps * D * kWin * (kRig ? 2 : 1);
  float* mlast = front + 2 * (size_t)c.Wp;
  const int nstrips = (c.Wp + c.S - 1) / c.S;
  const bool dp_cta = rank < c.ctas;
  const int lo = (int)((long long)rank * nstrips / c.ctas);
  const int hi = dp_cta ? (int)((long long)(rank + 1) * nstrips / c.ctas)
                        : 0;
  const int first = dp_cta && warp < c.warps ? lo + warp : hi;
  float* ering = smem + (size_t)warp * D * kWin;
  float* rring = smem + (size_t)(c.warps + warp) * D * kWin;
  Params p{c.e, c.rig, c.rigc, c.delta, c.H, c.Wp, h, c.S, c.G, c.K,
           nstrips, c.ctas, 1, cluster.map_shared_rank(mlast, 0), c.bp,
           nullptr};

  for (int i = gw * 32 + lane; i < (c.KC - c.kc) * c.H; i += nw * 32)
    c.hist[(size_t)c.kc * c.H + i] = -1;

#ifdef LQR_RESIDENT_PHASES
  unsigned long long t_phase = now_ns();
#endif
  for (int j = 0; j < c.kc; ++j) {
    const int w = c.w0 - j;
    const int s = c.d0 + j + 1;
    const bool left = c.ssf <= 0 || ((s - 1) / c.ssf) % 2 == 0;

    // ---- energy into the E scratch
    if (fam == kSumabs || fam == kNorm)
      energy_pass<true>(c, h, w, fam, gw, nw, lane);
    else
      energy_pass<false>(c, h, w, fam, gw, nw, lane);
    sync_cluster(cluster);
    LQR_PHASE(0);

    // ---- forward DP: row 0 into the DP blocks' frontiers, then the
    // strips (every block meets their barriers)
    if (h == 1) {
      if (rank == 0)
        for (int x = threadIdx.x; x < c.Wp; x += blockDim.x)
          mlast[x] = __ldcg(c.e + x);
    } else {
      if (dp_cta)
        for (int x = threadIdx.x; x < c.Wp; x += blockDim.x)
          front[x] = __ldcg(c.e + x);
      if (left)
        strip_sweep<kDelta, true, kRig, kOneStrip>(p, ering, rring, front,
                                                   first, hi, c.warps, lane,
                                                   cluster);
      else
        strip_sweep<kDelta, false, kRig, kOneStrip>(p, ering, rring, front,
                                                    first, hi, c.warps, lane,
                                                    cluster);
    }

    LQR_PHASE(1);

    // ---- start column and chase, on block 0
    if (rank == 0) {
      if (h == 1) __syncthreads();
      float bv = INFINITY;
      int bx = left ? c.Wp : -1;
      for (int x = threadIdx.x; x < w; x += blockDim.x) {
        const float v = mlast[x];
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
      __syncthreads();
      if (warp == 0) {
        bv = lane < nwarps ? red_v[lane] : INFINITY;
        bx = lane < nwarps ? red_x[lane] : (left ? c.Wp : -1);
        warp_best(bv, bx, left);
        // rows >= h carry the start, as pass-through rows (bp = 0) would
        for (int y = h + lane; y < c.H; y += 32) c.seam[y] = bx;
        warp_chase<CgLoad>(c.bp, c.Wp, h - 1, bx, c.seam, win, lane);
      }
    }
    sync_cluster(cluster);
    LQR_PHASE(2);

    // ---- record and compaction, two rows at a time a warp of the cluster
    compact_rows(c, j, w, gw, nw, lane);
    sync_cluster(cluster);
    LQR_PHASE(3);
  }

  // ---- zeros at x >= w0 - kc, as the per-seam steps leave them
  const int wf = c.w0 - c.kc;
  for (int y = gw; y < c.H; y += nw) {
    const size_t row = (size_t)y * c.Wp;
    for (int x = wf + lane; x < c.Wp; x += 32) {
      c.b[row + x] = 0.0f;
      c.pm[row + x] = 0;
      if (c.bias) c.bias[row + x] = 0.0f;
      if (kRig) c.rig[row + x] = 0.0f;
    }
  }
}

using Kernel = void (*)(Chunk);

template <int kDelta>
Kernel pick(bool rig, bool one_strip) {
  if (rig)
    return one_strip ? carve_resident_kernel<kDelta, true, true>
                     : carve_resident_kernel<kDelta, true, false>;
  return one_strip ? carve_resident_kernel<kDelta, false, true>
                   : carve_resident_kernel<kDelta, false, false>;
}

Kernel kernel_for(int delta, bool rig, bool one_strip) {
  switch (delta) {
    case 0: return pick<0>(rig, one_strip);
    case 1: return pick<1>(rig, one_strip);
    case 2: return pick<2>(rig, one_strip);
    case 3: return pick<3>(rig, one_strip);
    default: return pick<-1>(rig, one_strip);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether the kernel takes a geometry: a cluster of csize blocks of nwarps
// warps over planes of Wp columns, the DP's strips (ctas, warps, S, G, K)
bool geometry_ok(int Wp, int delta, int csize, int nwarps, int ctas,
                 int warps, int S, int G, int K) {
  if (Wp < 4 || Wp % 4 != 0 || delta < 0 || delta > kMaxDelta || S <= 0)
    return false;
  const int nstrips = (Wp + S - 1) / S;
  return S % 16 == 0 && S + 2 * G == kWin && K >= 1 &&
         (long long)delta * K <= G && warps >= 1 && warps <= nwarps &&
         nwarps * 32 <= kMaxThreads && warps <= nstrips && ctas >= 1 &&
         ctas <= csize && csize <= kMaxCtas && ctas <= nstrips;
}

// The kernel variant of a geometry and its blocks' dynamic shared memory
// (the DP warps' rings, the frontier pair, M_last), with the attribute that
// admits that much set: 0, or a cudaError_t (cleared).
int configure(int Wp, int delta, bool rig, int ctas, int warps, int S,
              Kernel* kern, size_t* smem) {
  const int optin = lqr_smem_optin();
  if (optin < 0) return -optin;
  *kern = kernel_for(delta, rig, ctas * warps == (Wp + S - 1) / S);
  *smem = (size_t)warps * kWarpRing + (size_t)3 * Wp * sizeof(float);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, *kern);
  if (err == cudaSuccess && *smem + attr.sharedSizeBytes > (size_t)optin)
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess &&
      *smem + attr.sharedSizeBytes > (size_t)kDefaultSmem)
    err = cudaFuncSetAttribute(*kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// The launch of `maps` clusters of csize blocks of nwarps warps; `at`
// holds its cluster attribute.
cudaLaunchConfig_t cluster_config(int maps, int csize, int nwarps,
                                  size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(maps * csize);
  cfg.blockDim = dim3(nwarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Check the chunk and its geometry, size the shared memory and launch
// `maps` clusters of csize blocks of nwarps warps.
int launch(Chunk c, int maps, int csize, int nwarps, cudaStream_t stream) {
  if (c.H < 1 || c.KC < 1 || c.nrg < 0 || c.nrg > 6 || maps < 1 ||
      !geometry_ok(c.Wp, c.delta, csize, nwarps, c.ctas, c.warps, c.S, c.G,
                   c.K))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(c.b) || !aligned16(c.pm) || !aligned16(c.e) ||
      (c.bias && !aligned16(c.bias)) || (c.rig && !aligned16(c.rig)))
    return (int)cudaErrorInvalidValue;
  Kernel kern;
  size_t smem;
  const int rc = configure(c.Wp, c.delta, c.rig != nullptr, c.ctas, c.warps,
                           c.S, &kern, &smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(maps, csize, nwarps, smem, stream, at);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, c);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// b, bias, rig: [B, H, Wp] f32, carved in place (bias and rig may be
// null); pm: [B, H, Wp] i32 posmap, carved in place; Wp a multiple of 4 and
// every plane 16-byte aligned. e: [B, H, Wp] f32, bp: [B, H, Wp] int8 and
// seam: [B, H] i32 scratch; hist: [B, KC, H] i32 out (rows >= kc set to
// -1); rigc: [B, delta_x + 1] f32 and params: [B, 4] i32 on the device,
// one row [w0, d0, kc, h] per map (0 <= kc <= min(KC, w0), w0 <= Wp, d0 >=
// 0, 1 <= h <= H; the caller checks them). One cluster per map of csize
// (1..8) blocks of nwarps (<= 8) warps; ctas, warps, S, G, K: the DP's
// strip geometry on the first ctas blocks' first warps warps (S a multiple
// of 16, S + 2 G = 256, G >= delta_x * K). Launches on `stream` and
// returns the launch's cudaError_t (0 on success), clearing it; a chunk or
// geometry the kernel cannot take never launches.
int lqr_carve_resident_batched(float* b, float* bias, float* rig, int* pm,
                               float* e, int8_t* bp, int* seam, int* hist,
                               const float* rigc, const int* params, int B,
                               int H, int Wp, int KC, int delta_x, int nrg,
                               int ssf, int csize, int nwarps, int ctas,
                               int warps, int S, int G, int K,
                               void* stream) {
  if (params == nullptr) return (int)cudaErrorInvalidValue;
  const Chunk c{b, bias, rig, pm, e, bp, seam, hist, rigc, params, H, Wp,
                0, 0, 0, KC, delta_x, nrg, ssf, ctas, warps, S, G, K};
  return launch(c, B, csize, nwarps, (cudaStream_t)stream);
}

// The most clusters of csize blocks of nwarps warps that the current
// device holds at once, for a chunk of Wp columns at the strip geometry
// (ctas, warps, S, G, K), with a rigidity plane or without: the answer of
// cudaOccupancyMaxActiveClusters for the kernel variant, the shared memory
// and the cluster that such a launch uses; or a negative cudaError_t.
// ops/carve_resident.py picks the launch's cluster by it.
int lqr_resident_clusters(int Wp, int delta_x, int has_rig, int csize,
                          int nwarps, int ctas, int warps, int S, int G,
                          int K) {
  if (!geometry_ok(Wp, delta_x, csize, nwarps, ctas, warps, S, G, K))
    return -(int)cudaErrorInvalidValue;
  Kernel kern;
  size_t smem;
  const int rc = configure(Wp, delta_x, has_rig != 0, ctas, warps, S, &kern,
                           &smem);
  if (rc != 0) return -rc;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(1, csize, nwarps, smem, nullptr, at);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

#ifdef LQR_RESIDENT_PHASES
// The phase sums of the launches since the last call (ns), then zeroed.
int lqr_resident_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // extern "C"
