"""The resident multi-seam carve: a whole chunk of seams in one launch.

Counterpart of ``lqr_tpu.ops.carve_resident``.
``carve_chunk_resident_batched`` carves one chunk for every map of a
``[B, H, Wb]`` batch in one launch, one cluster per map, each with its own
``w0``, ``d0``, ``kc``, true height ``h`` and row of a ``rigc [B,
delta_x + 1]`` table (rows >= h of a padded map pass through, as in
``lqr_tpu.core.dp``), and returns per map the compacted planes and posmap
after kc seams, every plane zero at x >= w0 - kc, and ``hist [KC, H]``
i32, the seams' reference columns (rows >= kc are -1; the JAX function
leaves them as garbage). ``carve_chunk_resident`` takes the JAX function's
arguments and returns its values: the same launch on one map, a batch of
one. The input tensors are left as they are. On CPU tensors it runs the
loop over the maps of ``carve_chunk_resident_plain``; on CUDA tensors it
launches ``csrc/carve_resident.cu`` on the current stream without
synchronizing (every scratch from ``torch.empty``), or raises. There is no
fallback from a failed launch to the plain version.

The kernel carves a chunk with one thread-block cluster per map
(``csrc/carve_resident.cu``): per seam an energy pass into an E scratch
over every warp of the cluster, the warp-strip DP of ``csrc/strip_dp.cuh``
on the geometry ``resident_geometry`` picks, the start column and the
windowed chase of ``csrc/chase.cuh`` on the cluster's first block, and the
record and compaction over every warp. It takes planes whose rows are a
multiple of 4 floats and 16-byte aligned: the wrapper carves copies
padded to ``padded_width(Wb)`` columns and returns them cut back to Wb.

The gate, ``resident_ok(B, ...)``, is the port's own. For one map it was
set by the medians of both extend_map routes in chip_smoke.py phase 5 and
tools/ab_timing.py (NVIDIA H100 80GB HBM3, 700 W): the resident route took
308 against 680-807 us/seam at cfg2 (1024x768 with bias and rigidity, 13.4
MB of planes), 119 against 500-546 at cfg1 (512x384, 1.8 MB) and 810
against 872-873 at 2048x2048 without masks (37.7 MB). So a batch of one
takes the resident route where its planes fit ``RESIDENT_BUDGET``, the
largest map measured: 2048x2048 without masks, 36 MiB, the main path.
Larger maps, where the cluster's energy pass and compaction (on 8 SMs)
grow with the map while the per-seam route's glue runs on every SM, are
not measured and keep the per-seam route. A batch of two or more maps
runs on all SMs at once and its planes stream from device memory whatever
their size, as they do on the per-seam route, which would carve the maps
one at a time; so it takes the resident kernel whenever its columns fit
the kernel (Wb <= MAX_WB). The TPU's criteria (H % CH, the 14 MB VMEM
limit) are not carried over.

The cluster follows the batch (``batch_cluster``): each map gets the first
of BATCH_CLUSTERS, (blocks, warps a block) from the most warps a map down,
of which the card holds all B clusters at once; the DP runs on
``strip_geometry``'s strips. The card says how many it holds
(``resident_clusters``: cudaOccupancyMaxActiveClusters for the launch's
kernel variant, shared memory and cluster, asked once per device, width,
delta_x, rigidity flag and cluster). One map gets 8 blocks of 8 warps. A
batch too large for every such cluster (a wave of 256 maps) keeps one
block of 4 warps per map (ONE_BLOCK), all in flight at once, two blocks an
SM. The list comes from tools/batch_clusters.py (NVIDIA H100 80GB HBM3,
700 W, 1024x1024 and 640x360 maps, B from 2 to 256): the most warps a map
won at every B where the card held them, and at equal warps fewer blocks
of 8 warps won (4 x 8 over 8 x 4, 2 x 8 over 4 x 4) but for one B within
2 %. The kernel's 255 registers a thread hold an SM to one block of 8
warps, and 15 clusters of 8 such blocks fit this card. ``BATCH_BLOCKS``
counts the launches by blocks a map (``profiling.COUNTERS``'s group
``BATCH_BLOCKS``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import profiling
from ..core.state import EngineConfig, to_device
from . import _build, dp_cuda

__all__ = ["RESIDENT_BUDGET", "MAX_WB", "BATCH_BLOCKS", "resident_bytes",
           "resident_ok", "batch_cluster", "resident_clusters",
           "carve_chunk_resident", "carve_chunk_resident_plain",
           "carve_chunk_resident_batched",
           "carve_chunk_resident_batched_plain"]

RESIDENT_BUDGET = 36 << 20      # bytes of planes: 2048 x 2048 x 9 B, the
                                # largest map measured (see the module doc)
MAX_WB = 8192                   # columns: the frontier pair and M_last
                                # fit shared memory beside the rings
# csrc/carve_resident.cu's clusters, (blocks, warps a block): most warps a
# map first, and one block a map; the static shared memory beside the
# dynamic (the chase's two windows and the warps' reduction slots)
BATCH_CLUSTERS = ((8, 8), (4, 8), (2, 8), (2, 4))
ONE_BLOCK = (1, 4)
STATIC_SMEM = 2 * 32 * 144 + 8 * 8

# the launches by blocks a map
BATCH_BLOCKS = profiling.group("BATCH_BLOCKS",
                               {"1": 0, "2": 0, "4": 0, "8": 0})


def padded_width(Wb: int) -> int:
    """The kernel's row stride for a map of Wb columns: a multiple of 4."""
    return -(-Wb // 4) * 4


def resident_geometry(Wp: int, delta_x: int, cluster, max_warps: int = 8):
    """(csize, nwarps, ctas, warps, S, G, K) of the resident kernel for a
    map of Wp columns on a cluster of csize blocks of nwarps warps (cluster
    = (csize, nwarps)), whose first ctas blocks' first warps warps run the
    DP's strips (S kept columns, G = (256 - S) / 2 halo columns, K rows
    between exchanges; see dp_cuda.strip_geometry). Two blocks or more:
    the strips of strip_geometry with at most min(nwarps, max_warps) warps
    a block, or None where those strips need more than csize blocks. One
    block (ONE_BLOCK): the fewest strips a warp whose halo is wide enough
    (G >= 8 * delta_x)."""
    csize, nwarps = cluster
    if csize > 1:
        ctas, warps, S, G, K = dp_cuda.strip_geometry(
            Wp, delta_x, min(nwarps, max_warps))
        if ctas > csize:
            return None
        return (csize, nwarps, ctas, warps, S, G, K)
    smax = dp_cuda.WINDOW - 16 * delta_x
    m = 1
    while -(-Wp // (nwarps * m * 16)) * 16 > smax:
        m += 1
    S = -(-Wp // (nwarps * m * 16)) * 16
    G = (dp_cuda.WINDOW - S) // 2
    return (1, nwarps, 1, min(nwarps, -(-Wp // S)), S, G,
            G // delta_x if delta_x else 64)


def _geometry(Wp: int, delta_x: int, cluster, device):
    room = dp_cuda.smem_optin(device) - STATIC_SMEM - 3 * Wp * 4
    return resident_geometry(Wp, delta_x, cluster,
                             room // dp_cuda.WARP_RING)


@functools.lru_cache(maxsize=64)
def resident_clusters(device, Wp: int, delta_x: int, has_rig: bool,
                      cluster) -> int:
    """How many clusters of resident_geometry's geometry for Wp columns on
    `cluster` = (blocks, warps a block) the CUDA device holds at once (0
    where the DP's strips need more blocks):
    cudaOccupancyMaxActiveClusters for the kernel variant, shared memory
    and cluster a launch uses; asked once per argument set."""
    geo = _geometry(Wp, delta_x, cluster, device)
    if geo is None:
        return 0
    lib = _build.load()
    with torch.cuda.device(device):
        n = lib.lqr_resident_clusters(Wp, delta_x, int(has_rig), *geo)
    if n < 0:
        _build.check(lib, -n, "lqr_resident_clusters")
    return n


def batch_cluster(B: int, clusters):
    """(blocks, warps a block) of each map in the launch for B maps: the
    first of BATCH_CLUSTERS of which the card holds all B at once
    (clusters(cluster): resident_clusters at the batch's device, Wp,
    delta_x and rigidity flag), else ONE_BLOCK."""
    for cluster in BATCH_CLUSTERS:
        if clusters(cluster) >= B:
            return cluster
    return ONE_BLOCK


def resident_bytes(H: int, Wb: int, has_bias: bool, has_rig: bool) -> int:
    """Bytes of the planes the kernel carries: reader + posmap (+ bias)
    (+ rig) at 4 B and the backpointers at 1 B per pixel."""
    return H * Wb * (4 * (2 + int(has_bias) + int(has_rig)) + 1)


def resident_ok(B: int, H: int, Wb: int, has_bias: bool,
                has_rig: bool) -> bool:
    """Whether a batch of B maps takes the resident route: one map whose
    planes fit RESIDENT_BUDGET, or two or more whose columns fit the
    kernel (see the module doc)."""
    return Wb <= MAX_WB and (
        B > 1 or resident_bytes(H, Wb, has_bias, has_rig) <= RESIDENT_BUDGET)


def carve_chunk_resident(cur_b, cur_bias, cur_rig, posmap, w0: int, d0: int,
                         kc: int, delta_x: int, has_bias: bool,
                         has_rig: bool, nrg: int, ssf: int, KC: int):
    """Carve kc <= KC seams at width w0, depth d0 off one map ([H, Wb]
    planes): carve_chunk_resident_batched on a batch of one. Returns (hist
    [KC, H] i32, cur_b', cur_bias', cur_rig', posmap')."""
    if cur_b.ndim != 2:
        raise ValueError(f"cur_b: expected [H, Wb], got {tuple(cur_b.shape)}")
    rigc = dp_cuda._rigc_device(delta_x, cur_b.shape[0], cur_b.device)
    out = carve_chunk_resident_batched(
        *(None if t is None else t[None]
          for t in (cur_b, cur_bias, cur_rig, posmap)),
        w0, d0, kc, cur_b.shape[0], rigc[None], delta_x, has_bias, has_rig,
        nrg, ssf, KC)
    return tuple(None if t is None else t[0] for t in out)


def _padded(t: torch.Tensor, Wp: int) -> torch.Tensor:
    """A fresh copy of t ([..., Wb]) with Wp >= Wb columns, zeros past Wb."""
    if t.shape[-1] == Wp:
        return t.clone()
    out = t.new_zeros(t.shape[:-1] + (Wp,))
    out[..., :t.shape[-1]] = t
    return out


def _cut(t: torch.Tensor, Wb: int) -> torch.Tensor:
    return t if t.shape[-1] == Wb else t[..., :Wb].contiguous()


def carve_chunk_resident_plain(cur_b, cur_bias, cur_rig, posmap, w0: int,
                               d0: int, kc: int, delta_x: int,
                               has_bias: bool, has_rig: bool, nrg: int,
                               ssf: int, KC: int, h=None, rigc_vec=None):
    """The plain version, on any device: kc per-seam steps of the engine
    with the plain DP and backtrack, each seam recorded through posmap;
    then zeros at x >= w0 - kc, as the kernel leaves them. h / rigc_vec:
    the map's true height and rigidity coefficients when it is padded to
    more rows (see core.dp)."""
    from ..core.engine import _carve_once   # core.engine imports this module
    H, Wb = cur_b.shape
    cfg = EngineConfig(H=H, Wb=Wb, C=1, delta_x=delta_x, nrg=nrg,
                       side_switch_freq=ssf, has_bias=has_bias,
                       has_rig=has_rig)
    hist = torch.full((KC, H), -1, dtype=torch.int32, device=cur_b.device)
    b, bias, rig, pm = cur_b, cur_bias, cur_rig, posmap
    for j in range(kc):
        seam, b, bias, rig, pm_next = _carve_once(
            cfg, b, bias, rig, pm, w0 - j, d0 + j + 1,
            find_seam=dp_cuda.find_seam_plain, h=h, rigc_vec=rigc_vec)
        hist[j] = pm.gather(1, seam[:, None].long())[:, 0]
        pm = pm_next
    keep = torch.arange(Wb, device=cur_b.device)[None, :] < w0 - kc
    b, pm = torch.where(keep, b, 0), torch.where(keep, pm, 0)
    if has_bias:
        bias = torch.where(keep, bias, 0)
    if has_rig:
        rig = torch.where(keep, rig, 0)
    return hist, b, bias, rig, pm


def _batched_params(B, H, Wb, w0, d0, kc, h, KC) -> np.ndarray:
    """The [B, 4] i32 host table [w0, d0, kc, h] of a batched chunk, each
    entry checked."""
    params = np.empty((B, 4), np.int64)
    for i, (name, col) in enumerate(zip(("w0", "d0", "kc", "h"),
                                        (w0, d0, kc, h))):
        v = np.asarray(col, np.int64).reshape(-1)
        if v.size not in (1, B):
            raise ValueError(f"per-map argument {name} has {v.size} "
                             f"entries for {B} maps")
        params[:, i] = v
    w0_, d0_, kc_, h_ = params.T
    bad = ((kc_ < 0) | (kc_ > KC) | (kc_ > w0_) | (w0_ > Wb) | (d0_ < 0)
           | (h_ < 1) | (h_ > H))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"map {i}: w0={w0_[i]} d0={d0_[i]} kc={kc_[i]} "
                         f"h={h_[i]} outside 0 <= kc <= min({KC}, w0), "
                         f"w0 <= {Wb}, d0 >= 0, 1 <= h <= {H}")
    return params.astype(np.int32)


def carve_chunk_resident_batched(cur_b, cur_bias, cur_rig, posmap, w0, d0,
                                 kc, h, rigc, delta_x: int, has_bias: bool,
                                 has_rig: bool, nrg: int, ssf: int, KC: int):
    """Carve kc[i] <= KC seams off every map i of a [B, H, Wb] batch, at
    width w0[i], depth d0[i] and true height h[i] (each a host int or a
    sequence of B), with the rigidity coefficients rigc [B, delta_x + 1]
    f32 on the planes' device. Returns (hist [B, KC, H] i32, cur_b',
    cur_bias', cur_rig', posmap'); cur_bias'/cur_rig' are the inputs when
    their flag is off."""
    if cur_b.ndim != 3:
        raise ValueError(f"cur_b: expected [B, H, Wb], got "
                         f"{tuple(cur_b.shape)}")
    shape, dev = tuple(cur_b.shape), cur_b.device
    B, H, Wb = shape
    dp_cuda._check(cur_b, "cur_b", torch.float32, shape, dev)
    dp_cuda._check(posmap, "posmap", torch.int32, shape, dev)
    for name, plane, flag in (("cur_bias", cur_bias, has_bias),
                              ("cur_rig", cur_rig, has_rig)):
        if flag:
            if plane is None:
                raise ValueError(f"{name} is None but its flag is set")
            dp_cuda._check(plane, name, torch.float32, shape, dev)
    if not 0 <= delta_x <= 10:
        raise ValueError(f"delta_x={delta_x} out of range 0..10")
    if not 0 <= nrg <= 6:
        raise ValueError(f"nrg={nrg} out of range 0..6")
    dp_cuda._check(rigc, "rigc", torch.float32, (B, delta_x + 1), dev)
    params = _batched_params(B, H, Wb, w0, d0, kc, h, KC)
    if dev.type == "cpu":
        return carve_chunk_resident_batched_plain(
            cur_b, cur_bias, cur_rig, posmap, params, rigc, delta_x,
            has_bias, has_rig, nrg, ssf, KC)
    if dev.type != "cuda":
        raise ValueError(f"cur_b: unsupported device {dev}")
    if Wb > MAX_WB:
        raise ValueError(f"Wb={Wb} exceeds the kernel's {MAX_WB}")

    lib = _build.load()
    Wp = padded_width(Wb)
    geo = _geometry(Wp, delta_x, batch_cluster(B, functools.partial(
        resident_clusters, dev, Wp, delta_x, has_rig)), dev)
    b, pm = _padded(cur_b, Wp), _padded(posmap, Wp)
    bias = _padded(cur_bias, Wp) if has_bias else cur_bias
    rig = _padded(cur_rig, Wp) if has_rig else cur_rig
    hist = torch.empty((B, KC, H), dtype=torch.int32, device=dev)
    e = torch.empty((B, H, Wp), dtype=torch.float32, device=dev)
    bp = torch.empty((B, H, Wp), dtype=torch.int8, device=dev)
    seam = torch.empty((B, H), dtype=torch.int32, device=dev)
    params_d = to_device(params, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_carve_resident_batched(
            b.data_ptr(), bias.data_ptr() if has_bias else None,
            rig.data_ptr() if has_rig else None, pm.data_ptr(),
            e.data_ptr(), bp.data_ptr(), seam.data_ptr(), hist.data_ptr(),
            rigc.data_ptr(), params_d.data_ptr(), B, H, Wp, int(KC),
            delta_x, nrg, int(ssf), *geo, stream)
    _build.check(lib, rc, "lqr_carve_resident_batched")
    dp_cuda.LAUNCHES["carve_resident"] += 1
    BATCH_BLOCKS[str(geo[0])] += 1
    return (hist, _cut(b, Wb), _cut(bias, Wb) if has_bias else bias,
            _cut(rig, Wb) if has_rig else rig, _cut(pm, Wb))


def carve_chunk_resident_batched_plain(cur_b, cur_bias, cur_rig, posmap,
                                       params, rigc, delta_x: int,
                                       has_bias: bool, has_rig: bool,
                                       nrg: int, ssf: int, KC: int):
    """The plain version of carve_chunk_resident_batched, on any device:
    the loop over the maps of carve_chunk_resident_plain. params: [B, 4]
    i32 rows [w0, d0, kc, h] (host)."""
    outs = []
    H = cur_b.shape[1]
    for i, (w0, d0, kc, h) in enumerate(params.tolist()):
        outs.append(carve_chunk_resident_plain(
            cur_b[i], cur_bias[i] if has_bias else None,
            cur_rig[i] if has_rig else None, posmap[i], w0, d0, kc, delta_x,
            has_bias, has_rig, nrg, ssf, KC, h=None if h == H else h,
            rigc_vec=rigc[i]))
    hist, b, bias, rig, pm = zip(*outs)
    return (torch.stack(hist), torch.stack(b),
            torch.stack(bias) if has_bias else cur_bias,
            torch.stack(rig) if has_rig else cur_rig, torch.stack(pm))
