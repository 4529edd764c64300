// The column-sharded forward DP of one seam, every shard and every block of
// rows in one launch, CUDA C++ for sm_90a.
//
// Replaces, for the shards of a mesh row that share one CUDA device, the
// per-block launches of the Pallas TPU kernel lqr_tpu/ops/dp_block.py:
// _dpb_kernel (dp_block.cu is its one-block counterpart, which meshes of
// distinct devices still launch). It computes what the per-block loop of
// lqr_tpu/parallel/sharding.py:_dp_local_blocked computes. Shard c holds E
// (and rig) [H, Wl]. Before each block of R rows it receives, from each
// neighbour, G = max(R * delta_x, 1) frontier values and [R, G] energy and
// rigidity slabs (+inf frontier and energy, zero rigidity at the mesh's
// edges, and everywhere when delta_x = 0, where nothing is exchanged), and
// runs R rows of seam_dp.cuh's cell rule over its extended slab of We = Wl +
// 2G columns, +inf beyond it:
//
//   M[y, x] = E[y, x] + min_{|dx| <= delta_x} ( M[y-1, x+dx] + rig[y, x] * rigc[|dx|] )
//
// with M = E, bp = 0 on the image's row 0. It keeps M and bp of the own
// columns [G, G + Wl): outputs m_last [n, Wl] f32 and bp [n, H, Wl] int8,
// bit-equal to the per-block loop, whose halo lanes are upper bounds that
// never reach the own columns.
//
// Design: one thread-block cluster, one block a shard (cluster size n <=
// 8). Each block keeps its shard's extended frontier pair in shared memory,
// or, for slabs too wide for it, in a device scratch of its own. At each
// boundary of R rows: a cluster barrier; each block reads its neighbours'
// G edge values of the frontier straight from their shared memory
// (distributed shared memory) or scratch into its halo columns; a second
// cluster barrier, split into an arrive after the reads and a wait before
// the block next writes a frontier. The kernel takes each shard's planes
// where they lie (an array of n base pointers); a block reads its own
// shard's columns and, of each neighbour, only the G columns of that
// neighbour's edge that the multi-device exchange sends, one row at a time.
// No host packing, no stacked copy, no per-block launch.
//
// Inside a block, the warp strips of strip_dp.cuh (row_step, 8 columns a
// lane, neighbours by shuffle): strips of S kept columns of a 256-column
// window with Gi = round_up(delta_x * K, 8) halo columns on each side, K
// rows between reloads of the window from the block's frontier (one
// __syncthreads per K rows, a K-row block never crossing an exchange), each
// lane streaming its columns of E (and rig) from their planes through a
// ring of 8 rows in shared memory with cp.async. Up to 16 warps a block;
// a slab of more strips gives each warp several, run in turn between two
// reloads (ops/dp_block.py:sharded_geometry picks the geometry; the
// launcher checks it).
//
// What bounds it on this card: the row chain. The launch runs H dependent
// rows; each row is a serial chain of a few hundred cycles (the cells of 8
// columns, the shuffles, the ring), and a cluster barrier every R rows.
// Bytes (E read once, bp written once, about 21 MB at 2048^2) would take
// about 6 us. What the design does about it: one launch for all H rows and
// all shards, no cell waits on a global load, and the frontier exchange in
// shared memory instead of device memory and host copies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "strip_dp.cuh"

namespace {

constexpr int kMaxShards = 8;       // the portable cluster size
constexpr int kRing = 8;            // rows a warp streams ahead
constexpr int kStripWarps = 16;
constexpr int kSmallSmem = 48 * 1024;

struct ShardParams {
  const float* e[kMaxShards];     // shard c's [H, Wl] energy plane
  const float* rig[kMaxShards];   // its rigidity plane (null without)
  const float* rigc;              // [delta + 1]
  float* m_last;                  // [n, Wl]
  int8_t* bp;                     // [n, H, Wl]
  float* gfront;                  // [n, 2, Wp] frontier pairs, or null
  int n, H, Wl, R, G, delta, exchange;
  int K, Gi, S, nstrips;          // the strips: rows between reloads,
                                  // window halo, kept columns, count
  int vec16;   // Wl % 4 == 0, G % 4 == 0 and every plane 16-byte aligned
};

// The planes a block's slab reads: the left neighbour's, its own, the right
// neighbour's (null where no neighbour sends).
struct Bases {
  const float* l;
  const float* m;
  const float* r;
};

// Bases of shard c in one of the param arrays, indexed by constants only
// (a run-time index into a kernel parameter would copy it to local memory).
__device__ __forceinline__ Bases bases_of(const float* const (&a)[kMaxShards],
                                          const ShardParams& p, int c) {
  Bases b{nullptr, nullptr, nullptr};
#pragma unroll
  for (int i = 0; i < kMaxShards; ++i) {
    if (i == c - 1 && p.exchange) b.l = a[i];
    if (i == c) b.m = a[i];
    if (i == c + 1 && p.exchange) b.r = a[i];
  }
  return b;
}

// Row 0 of column j of the block's extended slab, or null where the slab
// holds +inf energy and zero rigidity: beyond it, and in a halo that no
// neighbour sends.
__device__ __forceinline__ const float* slab_src(const Bases& b,
                                                 const ShardParams& p,
                                                 int j) {
  if (j < 0 || j >= p.Wl + 2 * p.G) return nullptr;
  if (j < p.G) return b.l ? b.l + p.Wl - p.G + j : nullptr;
  if (j < p.G + p.Wl) return b.m + j - p.G;
  return b.r ? b.r + j - p.G - p.Wl : nullptr;
}

// The end of the K-row block that starts at row y0: K rows, cut at the next
// exchange (a multiple of R) and at H.
__device__ __forceinline__ int kblock_end(const ShardParams& p, int y0) {
  return min(min(y0 + p.K, (y0 / p.R + 1) * p.R), p.H);
}

// A warp's place in its stream of (strip, row) tasks: row y of strip t in
// the K-row block [y0, y1).
struct Step {
  int y0, y1, t, y;
};

// A warp runs strips first, first + nwarps, ... of every K-row block.
__device__ __forceinline__ void next_step(Step& k, const ShardParams& p,
                                          int first, int nwarps) {
  if (++k.y == k.y1) {
    k.t += nwarps;
    if (k.t >= p.nstrips) {
      k.t = first;
      k.y0 = k.y1;
      k.y1 = kblock_end(p, k.y0);
    }
    k.y = k.y0;
  }
}

// The lane's 8 columns of the strip its fetches read: row 0 of each in its
// plane (any valid address where it has none), and which have a source.
struct Source {
  int t;
  unsigned in;
  const float* se[kCols];
  const float* sr[kCols];
};

template <bool kRig>
__device__ __forceinline__ void point(Source& s, const ShardParams& p,
                                      const Bases& eb, const Bases& rb,
                                      int t, int lane) {
  const int xl = t * p.S - p.Gi + kCols * lane;
  s.t = t;
  s.in = 0u;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const float* a = slab_src(eb, p, xl + q);
    s.se[q] = a ? a : eb.m;
    s.in |= (a ? 1u : 0u) << q;
    if (kRig) {
      const float* b = slab_src(rb, p, xl + q);
      s.sr[q] = b ? b : rb.m;
    }
  }
}

// Row `row` (an offset, y * Wl) of the lane's columns of E (and rig) into a
// ring stage; slots with no source get +inf and 0. vec16: each group of 4
// columns is one 16-byte-aligned run of one plane, or has no source.
template <bool kRig>
__device__ __forceinline__ void fetch_src(const Source& s, bool vec16,
                                      size_t row, float* es, float* rs,
                                      int lane) {
  float* de = es + kCols * lane;
  float* dr = rs + kCols * lane;
  if (vec16) {
#pragma unroll
    for (int g = 0; g < kCols; g += 4) {
      const bool on = (s.in >> g) & 1u;
      cp_async16(de + g, s.se[g] + row, on);
      if (kRig) cp_async16(dr + g, s.sr[g] + row, on);
      if (!on) {
        *reinterpret_cast<float4*>(de + g) =
            make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
        if (kRig)
          *reinterpret_cast<float4*>(dr + g) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const bool on = (s.in >> q) & 1u;
    cp_async4(de + q, s.se[q] + row, on);
    if (kRig) cp_async4(dr + q, s.sr[q] + row, on);
    if (!on) {
      de[q] = INFINITY;
      if (kRig) dr[q] = 0.0f;
    }
  }
}

// The next task of the warp's stream into ring stage `stage`, then a
// commit group (empty past the last task, so that wait_group<D - 1>
// counts the same everywhere).
template <bool kRig>
__device__ __forceinline__ void refill(Step& k, Source& s,
                                       const ShardParams& p, const Bases& eb,
                                       const Bases& rb, int first, int nwarps,
                                       float* es, float* rs, int lane) {
  if (k.y0 < p.H) {
    if (k.t != s.t) point<kRig>(s, p, eb, rb, k.t, lane);
    fetch_src<kRig>(s, p.vec16 != 0, (size_t)k.y * p.Wl, es, rs, lane);
    next_step(k, p, first, nwarps);
  }
  cp_async_commit();
}

// The lane's backpointers of one row into its own columns o .. o + 7 of a
// bp row (mode 1: all 8 own, one aligned 8-byte store; 2: all 8 own; 3:
// some).
__device__ __forceinline__ void store_bp_own(int8_t* row, int o, int Wl,
                                             int mode, uint32_t w0,
                                             uint32_t w1) {
  if (mode == 1) {
    *reinterpret_cast<uint2*>(row + o) = make_uint2(w0, w1);
  } else if (mode == 2) {
    store_bp(row, o, Wl, w0, w1);
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (o + q >= 0 && o + q < Wl)
        row[o + q] = (int8_t)(((q < 4 ? w0 : w1) >> (8 * (q & 3))) & 0xffu);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The frontier exchange into f (this block's frontier row, its own columns
// complete in every block of the cluster): the halo columns get each
// neighbour's G edge values, read from the neighbour's shared memory or,
// with device-scratch frontiers, from its scratch past the L1 (its rows
// lie 2 * Wp floats from this block's), or +inf.
__device__ __forceinline__ void halo_fill(float* f, const ShardParams& p,
                                          int c, int Wp,
                                          cg::cluster_group cluster) {
  const bool from_l = p.exchange && c > 0;
  const bool from_r = p.exchange && c < p.n - 1;
  if (p.gfront) {
    const float* fl = f - 2 * (ptrdiff_t)Wp;
    const float* fr = f + 2 * (ptrdiff_t)Wp;
    for (int j = threadIdx.x; j < p.G; j += blockDim.x) {
      f[j] = from_l ? __ldcg(fl + p.Wl + j) : INFINITY;
      f[p.G + p.Wl + j] = from_r ? __ldcg(fr + p.G + j) : INFINITY;
    }
    return;
  }
  const float* fl = from_l ? cluster.map_shared_rank(f, c - 1) : nullptr;
  const float* fr = from_r ? cluster.map_shared_rank(f, c + 1) : nullptr;
  for (int j = threadIdx.x; j < p.G; j += blockDim.x) {
    f[j] = from_l ? fl[p.Wl + j] : INFINITY;            // its Wl - G + j
    f[p.G + p.Wl + j] = from_r ? fr[p.G + j] : INFINITY;  // its j
  }
}

template <int kDelta, bool kLeft, bool kRig>
__global__ void __launch_bounds__(kStripWarps * 32)
    dp_sharded_kernel(const ShardParams p) {
  constexpr int D = kRing;
  constexpr int DM = max_delta(kDelta);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int delta = kDelta >= 0 ? kDelta : p.delta;
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int We = p.Wl + 2 * p.G;
  const int Wp = (We + 3) & ~3;
  float* ering = smem + (size_t)warp * D * kWin;
  float* rring = smem + (size_t)(nwarps + warp) * D * kWin;
  float* front = p.gfront
                     ? p.gfront + (size_t)c * 2 * Wp
                     : smem + (size_t)nwarps * D * kWin * (kRig ? 2 : 1);
  const Bases eb = bases_of(p.e, p, c);
  const Bases rb = kRig ? bases_of(p.rig, p, c) : Bases{nullptr, nullptr,
                                                        nullptr};
  int8_t* bpc = p.bp + (size_t)c * p.H * p.Wl;

  float rc[DM + 1];
#pragma unroll
  for (int k = 0; k <= DM; ++k)
    rc[k] = (kRig && k >= 1 && (kDelta >= 0 || k <= delta)) ? p.rigc[k] : 0.f;

  // row 0: the slab's E into frontier row 0, bp = 0 in the own columns
  for (int x = threadIdx.x; x < We; x += blockDim.x) {
    const float* s = slab_src(eb, p, x);
    front[x] = s ? *s : INFINITY;
  }
  for (int x = threadIdx.x; x < p.Wl; x += blockDim.x) bpc[x] = 0;

  // the ring: the warp's first D tasks
  const int first = warp;
  Step pk = first < p.nstrips ? Step{1, kblock_end(p, 1), first, 1}
                              : Step{p.H, p.H, first, p.H};
  Source src;
  src.t = -1;
#pragma unroll 1
  for (int s = 0; s < D; ++s)
    refill<kRig>(pk, src, p, eb, rb, first, nwarps, ering + s * kWin,
                 rring + s * kWin, lane);
  __syncthreads();

  int stage = 0, fb = 0;
  bool pend = false;
  for (int y0 = 1; y0 < p.H;) {
    const int y1 = kblock_end(p, y0);
    const float* cur = front + (size_t)fb * Wp;
    float* nxt = front + (size_t)(fb ^ 1) * Wp;
    for (int t = first; t < p.nstrips; t += nwarps) {
      const int xl = t * p.S - p.Gi + kCols * lane;
      const bool kept = lane >= p.Gi / kCols &&
                        lane < (p.Gi + p.S) / kCols && xl < We;
      // the lane's backpointer stores: 0 none; else how many of its 8
      // columns are own (store_bp_own's modes)
      const int o = xl - p.G;
      int mode = 0;
      if (kept && o + kCols > 0 && o < p.Wl) {
        const bool aligned =
            (p.Wl & 7) == 0 && (o & 7) == 0 &&
            (reinterpret_cast<uintptr_t>(bpc) & 7) == 0;
        mode = o >= 0 && o + kCols <= p.Wl ? (aligned ? 1 : 2) : 3;
      }
      float m[kCols];
      load_front(m, cur, xl, We);
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
          for (int q = 0; q < kCols; ++q) r[q] = 0.0f;
        }
        uint32_t w0, w1;
        row_step<kDelta, kLeft, kRig>(m, e, r, rc, delta, w0, w1);
        if (mode) store_bp_own(bpc + (size_t)y * p.Wl, o, p.Wl, mode, w0, w1);
        // the stage was read: refill it with the stream's next task
        refill<kRig>(pk, src, p, eb, rb, first, nwarps, ering + stage * kWin,
                     rring + stage * kWin, lane);
        stage = stage + 1 == D ? 0 : stage + 1;
      }
      // no frontier moves on while a neighbour may still read one
      if (pend) {
        cluster_wait();
        pend = false;
      }
      if (kept) store_front(nxt, m, xl, We);
    }
    if (pend) {   // a warp with no strip
      cluster_wait();
      pend = false;
    }
    if (y1 % p.R == 0 && y1 < p.H) {
      // the halo exchange: every block's frontier complete, then each
      // reads its neighbours' edges
      if (p.exchange) {
        if (p.gfront) __threadfence();
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      halo_fill(nxt, p, c, Wp, cluster);
      __syncthreads();
      if (p.exchange) {
        cluster_arrive();
        pend = true;
      }
    } else {
      __syncthreads();
    }
    fb ^= 1;
    y0 = y1;
  }
  cp_async_wait<0>();
  const float* fin = front + (size_t)fb * Wp;
  for (int x = threadIdx.x; x < p.Wl; x += blockDim.x)
    p.m_last[(size_t)c * p.Wl + x] = fin[p.G + x];
}

using Kernel = void (*)(ShardParams);

template <int kDelta>
Kernel pick(bool left, bool rig) {
  if (left)
    return rig ? dp_sharded_kernel<kDelta, true, true>
               : dp_sharded_kernel<kDelta, true, false>;
  return rig ? dp_sharded_kernel<kDelta, false, true>
             : dp_sharded_kernel<kDelta, false, false>;
}

Kernel kernel_for(int delta, bool left, bool rig) {
  switch (delta) {
    case 0: return pick<0>(left, rig);
    case 1: return pick<1>(left, rig);
    case 2: return pick<2>(left, rig);
    case 3: return pick<3>(left, rig);
    default: return pick<-1>(left, rig);
  }
}

}  // namespace

extern "C" {

int lqr_smem_optin(void);

// e, rig: host arrays of n device pointers, each shard's [H, Wl] f32 plane
// (rig null without rigidity); rigc: [delta_x + 1] f32 on the device; R:
// rows per halo exchange (H % R == 0, G = max(R * delta_x, 1) <= Wl); the
// strips: warps (1..16, at most ceil((Wl + 2G) / S)), K >= 1, Gi a
// multiple of 8 with delta_x * K <= Gi, S + 2 * Gi == 256; m_last: [n, Wl]
// f32; bp: [n, H, Wl] int8; scratch: null, or [n, 2, round_up(Wl + 2G, 4)]
// f32 on the device to hold the frontier pairs when they and the rings do
// not fit the opt-in shared memory together. One cluster of n (1..8)
// blocks. Launches on `stream` and returns the launch's cudaError_t (0 on
// success), clearing it. A shape or geometry the kernel cannot take never
// launches.
int lqr_dp_sharded(const float* const* e, const float* const* rig,
                   const float* rigc, int pref_left, int delta_x, int n,
                   int H, int Wl, int R, int warps, int K, int Gi, int S,
                   float* m_last, int8_t* bp, float* scratch, void* stream) {
  if (n < 1 || n > kMaxShards || H < 1 || Wl < 1 || R < 1 || H % R != 0 ||
      delta_x < 0 || delta_x > kMaxDelta)
    return (int)cudaErrorInvalidValue;
  const int G = R * delta_x > 1 ? R * delta_x : 1;
  const int We = Wl + 2 * G;
  const int nstrips = S > 0 ? (We + S - 1) / S : 0;
  if (G > Wl || S <= 0 || Gi < 0 || Gi % kCols != 0 || S + 2 * Gi != kWin ||
      K < 1 || (long long)delta_x * K > Gi || warps < 1 ||
      warps > kStripWarps || warps > nstrips)
    return (int)cudaErrorInvalidValue;
  const bool has_rig = rig != nullptr;
  ShardParams p{};
  bool vec16 = Wl % 4 == 0 && G % 4 == 0;
  for (int c = 0; c < n; ++c) {
    p.e[c] = e[c];
    p.rig[c] = has_rig ? rig[c] : nullptr;
    vec16 = vec16 && reinterpret_cast<uintptr_t>(e[c]) % 16 == 0 &&
            (!has_rig || reinterpret_cast<uintptr_t>(rig[c]) % 16 == 0);
  }
  const size_t front =
      scratch ? 0 : (size_t)2 * ((We + 3) & ~3) * sizeof(float);
  const size_t smem =
      (size_t)warps * kRing * kWin * sizeof(float) * (has_rig ? 2 : 1) +
      front;
  const int optin = lqr_smem_optin();
  if (optin < 0) return -optin;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  Kernel kern = kernel_for(delta_x, pref_left != 0, has_rig);
  if (smem > (size_t)kSmallSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  p.rigc = rigc;
  p.m_last = m_last;
  p.bp = bp;
  p.gfront = scratch;
  p.n = n;
  p.H = H;
  p.Wl = Wl;
  p.R = R;
  p.G = G;
  p.delta = delta_x;
  p.exchange = n > 1 && delta_x > 0 ? 1 : 0;
  p.K = K;
  p.Gi = Gi;
  p.S = S;
  p.nstrips = nstrips;
  p.vec16 = vec16 ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
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

}  // extern "C"
