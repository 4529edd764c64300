"""The resident multi-seam carve: a whole chunk of seams in one launch.

Counterpart of ``lqr_tpu.ops.carve_resident``. ``carve_chunk_resident``
takes the JAX function's arguments and returns its values: the compacted
planes and posmap after kc seams, every plane zero at x >= w0 - kc, and
``hist [KC, H]`` i32, the seams' reference columns (rows >= kc are -1; the
JAX function leaves them as garbage). The input tensors are left as they
are. On a CPU tensor it runs ``carve_chunk_resident_plain``; on a CUDA
tensor it launches ``csrc/carve_resident.cu`` on the current stream
without synchronizing (every scratch from ``torch.empty``), or raises.
There is no fallback from a failed launch to the plain version.

The kernel carves a chunk with one thread-block cluster per map
(``csrc/carve_resident.cu``): per seam an energy pass into an E scratch
over every warp of the cluster, the warp-strip DP of ``csrc/strip_dp.cuh``
on the geometry ``resident_geometry`` picks, the start column and the
windowed chase of ``csrc/chase.cuh`` on the cluster's first block, and the
record and compaction over every warp. It takes planes whose rows are a
multiple of 4 floats and 16-byte aligned: the wrapper carves copies
padded to ``padded_width(Wb)`` columns and returns them cut back to Wb.

The gate is the port's own, set by the medians of both extend_map routes
in chip_smoke.py phase 5 and tools/ab_timing.py (NVIDIA H100 80GB HBM3,
700 W): the resident route took 308 against 680-807 us/seam at cfg2
(1024x768 with bias and rigidity, 13.4 MB of planes), 119 against 500-546
at cfg1 (512x384, 1.8 MB) and 810 against 872-873 at 2048x2048 without
masks (37.7 MB). So ``resident_ok`` admits a map whose planes fit
``RESIDENT_BUDGET``, the largest map measured: 2048x2048 without masks,
36 MiB, the main path, takes the resident route. Larger maps, where the
cluster's energy pass and compaction (on 8 SMs) grow with the map while
the per-seam route's glue runs on every SM, are not measured and keep the
per-seam route. The TPU's criteria (H % CH, the 14 MB VMEM limit) are not
carried over.

``carve_chunk_resident_batched`` carves one chunk for every map of a
``[B, H, Wb]`` batch in one launch, one cluster per map, each with its own
``w0``, ``d0``, ``kc``, true height ``h`` and row of a ``rigc [B,
delta_x + 1]`` table (rows >= h of a padded map pass through, as in
``lqr_tpu.core.dp``). Its plain version is the loop over the maps of
``carve_chunk_resident_plain``. Its gate, ``batched_resident_ok``, is not
the solo gate: a batch's maps run on all SMs at once and their planes
stream from device memory whatever their size, as they do on the per-seam
route, which would carve the maps one at a time. So a batch of two or more
maps takes the batched kernel whenever its columns fit the kernel (Wb <=
MAX_WB); a batch of one keeps the solo gate.

The batched entry's cluster follows the batch (``batch_cluster``): each
map gets the first of BATCH_CLUSTERS, (blocks, warps a block) from the
most warps a map down, of which the card holds all B clusters at once; the
DP runs on ``strip_geometry``'s strips, as in the solo entry. The card says
how many it holds (``resident_clusters``: cudaOccupancyMaxActiveClusters
for the launch's kernel variant, shared memory and cluster, asked once per
device, width, delta_x, rigidity flag and cluster). A batch too large for
every such cluster (a wave of 256 maps) keeps one block of 4 warps per map
(ONE_BLOCK), all in flight at once, two blocks an SM; a batch of one,
under the solo gate, gets the solo entry's cluster. The list comes from
tools/batch_clusters.py (NVIDIA H100 80GB HBM3, 700 W, 1024x1024 and
640x360 maps, B from 2 to 256): the most warps a map won at every B where
the card held them, and at equal warps fewer blocks of 8 warps won (4 x 8
over 8 x 4, 2 x 8 over 4 x 4) but for one B within 2 %. The kernel's 255
registers a thread hold an SM to one block of 8 warps, and 15 clusters of
8 such blocks fit this card. ``BATCH_BLOCKS`` counts the batched launches
by blocks a map (``profiling.COUNTERS``'s group ``BATCH_BLOCKS``).
"""

from __future__ import annotations

import functools

import torch

from .. import profiling
from ..core.state import EngineConfig
from . import _build, dp_cuda

__all__ = ["RESIDENT_BUDGET", "MAX_WB", "BATCH_BLOCKS", "resident_bytes",
           "resident_ok", "batched_resident_ok", "batch_cluster",
           "resident_clusters", "carve_chunk_resident",
           "carve_chunk_resident_plain", "carve_chunk_resident_batched",
           "carve_chunk_resident_batched_plain"]

RESIDENT_BUDGET = 36 << 20      # bytes of planes: 2048 x 2048 x 9 B, the
                                # largest map measured (see the module doc)
MAX_WB = 8192                   # columns: the frontier pair and M_last
                                # fit shared memory beside the rings
# csrc/carve_resident.cu's clusters, (blocks, warps a block): the solo
# entry's; the batched entry's, most warps a map first, and its one block a
# map; the static shared memory beside the dynamic (the chase's two windows
# and the warps' reduction slots)
SOLO_CLUSTER = (8, 8)
BATCH_CLUSTERS = ((8, 8), (4, 8), (2, 8), (2, 4))
ONE_BLOCK = (1, 4)
STATIC_SMEM = 2 * 32 * 144 + 8 * 8

# the batched entry's launches by blocks a map
BATCH_BLOCKS = profiling.group("BATCH_BLOCKS",
                               {"1": 0, "2": 0, "4": 0, "8": 0})


def padded_width(Wb: int) -> int:
    """The kernel's row stride for a map of Wb columns: a multiple of 4."""
    return -(-Wb // 4) * 4


def resident_geometry(Wp: int, delta_x: int, cluster=SOLO_CLUSTER,
                      max_warps: int = SOLO_CLUSTER[1]):
    """(csize, nwarps, ctas, warps, S, G, K) of the resident kernel for a
    map of Wp columns on a cluster of csize blocks of nwarps warps (cluster
    = (csize, nwarps)), whose first ctas blocks' first warps warps run the
    DP's strips (S kept columns, G = (256 - S) / 2 halo columns, K rows
    between exchanges; see dp_cuda.strip_geometry). Two blocks or more (the
    solo entry, the batched entry's wider clusters): the strips of
    strip_geometry with at most min(nwarps, max_warps) warps a block, or
    None where those strips need more than csize blocks. One block (the
    batched entry's ONE_BLOCK): the fewest strips a warp whose halo is wide
    enough (G >= 8 * delta_x)."""
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
                             min(SOLO_CLUSTER[1], room // dp_cuda.WARP_RING))


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
    """(blocks, warps a block) of each map in the batched entry's launch
    for B maps: the first of BATCH_CLUSTERS of which the card holds all B
    at once (clusters(cluster): resident_clusters at the batch's device,
    Wp, delta_x and rigidity flag), else ONE_BLOCK."""
    for cluster in BATCH_CLUSTERS:
        if clusters(cluster) >= B:
            return cluster
    return ONE_BLOCK


def resident_bytes(H: int, Wb: int, has_bias: bool, has_rig: bool) -> int:
    """Bytes of the planes the kernel carries: reader + posmap (+ bias)
    (+ rig) at 4 B and the backpointers at 1 B per pixel."""
    return H * Wb * (4 * (2 + int(has_bias) + int(has_rig)) + 1)


def resident_ok(H: int, Wb: int, has_bias: bool, has_rig: bool) -> bool:
    """Whether extend_map takes the resident route for this map."""
    return (Wb <= MAX_WB
            and resident_bytes(H, Wb, has_bias, has_rig) <= RESIDENT_BUDGET)


def batched_resident_ok(B: int, H: int, Wb: int, has_bias: bool,
                        has_rig: bool) -> bool:
    """Whether a batch of B maps takes the batched resident kernel (see the
    module doc)."""
    if B == 1:
        return resident_ok(H, Wb, has_bias, has_rig)
    return Wb <= MAX_WB


def _check_args(cur_b, cur_bias, cur_rig, posmap, w0, d0, kc, delta_x,
                has_bias, has_rig, nrg, KC) -> None:
    if cur_b.ndim != 2:
        raise ValueError(f"cur_b: expected [H, Wb], got {tuple(cur_b.shape)}")
    shape, dev = tuple(cur_b.shape), cur_b.device
    dp_cuda._check(cur_b, "cur_b", torch.float32, shape, dev)
    dp_cuda._check(posmap, "posmap", torch.int32, shape, dev)
    for name, plane, flag in (("cur_bias", cur_bias, has_bias),
                              ("cur_rig", cur_rig, has_rig)):
        if flag:
            if plane is None:
                raise ValueError(f"{name} is None but its flag is set")
            dp_cuda._check(plane, name, torch.float32, shape, dev)
    if not 0 <= kc <= KC:
        raise ValueError(f"kc={kc} out of range 0..{KC}")
    if not kc <= w0 <= shape[1]:
        raise ValueError(f"w0={w0} must lie in [kc={kc}, Wb={shape[1]}]")
    if d0 < 0:
        raise ValueError(f"d0={d0} must be >= 0")
    if not 0 <= delta_x <= 10:
        raise ValueError(f"delta_x={delta_x} out of range 0..10")
    if not 0 <= nrg <= 6:
        raise ValueError(f"nrg={nrg} out of range 0..6")


def carve_chunk_resident(cur_b, cur_bias, cur_rig, posmap, w0: int, d0: int,
                         kc: int, delta_x: int, has_bias: bool,
                         has_rig: bool, nrg: int, ssf: int, KC: int):
    """Carve kc <= KC seams at width w0, depth d0. Returns (hist [KC, H]
    i32, cur_b', cur_bias', cur_rig', posmap'); cur_bias'/cur_rig' are the
    inputs when their flag is off."""
    _check_args(cur_b, cur_bias, cur_rig, posmap, w0, d0, kc, delta_x,
                has_bias, has_rig, nrg, KC)
    if cur_b.device.type == "cpu":
        return carve_chunk_resident_plain(cur_b, cur_bias, cur_rig, posmap,
                                          w0, d0, kc, delta_x, has_bias,
                                          has_rig, nrg, ssf, KC)
    if cur_b.device.type != "cuda":
        raise ValueError(f"cur_b: unsupported device {cur_b.device}")
    H, Wb = cur_b.shape
    if Wb > MAX_WB:
        raise ValueError(f"Wb={Wb} exceeds the kernel's {MAX_WB}")

    lib = _build.load()
    dev = cur_b.device
    Wp = padded_width(Wb)
    geo = _geometry(Wp, delta_x, SOLO_CLUSTER, dev)
    # the kernel carves in place: it works on (padded) copies
    b, pm = _padded(cur_b, Wp), _padded(posmap, Wp)
    bias = _padded(cur_bias, Wp) if has_bias else cur_bias
    rig = _padded(cur_rig, Wp) if has_rig else cur_rig
    hist = torch.empty((KC, H), dtype=torch.int32, device=dev)
    e = torch.empty((H, Wp), dtype=torch.float32, device=dev)
    bp = torch.empty((H, Wp), dtype=torch.int8, device=dev)
    seam = torch.empty(H, dtype=torch.int32, device=dev)
    rigc = dp_cuda._rigc_device(delta_x, H, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_carve_resident(
            b.data_ptr(), bias.data_ptr() if has_bias else None,
            rig.data_ptr() if has_rig else None, pm.data_ptr(),
            e.data_ptr(), bp.data_ptr(), seam.data_ptr(), hist.data_ptr(),
            rigc.data_ptr(), H, Wp, int(w0), int(d0), int(kc), int(KC),
            delta_x, nrg, int(ssf), *geo, stream)
    _build.check(lib, rc, "lqr_carve_resident")
    dp_cuda.LAUNCHES["carve_resident"] += 1
    return (hist, _cut(b, Wb), _cut(bias, Wb) if has_bias else bias,
            _cut(rig, Wb) if has_rig else rig, _cut(pm, Wb))


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


def _batched_params(B, H, Wb, w0, d0, kc, h, KC) -> torch.Tensor:
    """The [B, 4] i32 host table [w0, d0, kc, h] of a batched chunk, each
    entry checked."""
    params = torch.zeros((B, 4), dtype=torch.int32)
    for i, col in enumerate((w0, d0, kc, h)):
        v = torch.as_tensor(col, dtype=torch.int64).reshape(-1)
        if v.numel() == 1:
            v = v.expand(B)
        if v.numel() != B:
            raise ValueError(f"per-map argument {('w0', 'd0', 'kc', 'h')[i]}"
                             f" has {v.numel()} entries for {B} maps")
        params[:, i] = v
    w0_, d0_, kc_, h_ = params.unbind(1)
    bad = ((kc_ < 0) | (kc_ > KC) | (kc_ > w0_) | (w0_ > Wb) | (d0_ < 0)
           | (h_ < 1) | (h_ > H))
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise ValueError(f"map {i}: w0={int(w0_[i])} d0={int(d0_[i])} "
                         f"kc={int(kc_[i])} h={int(h_[i])} outside "
                         f"0 <= kc <= min({KC}, w0), w0 <= {Wb}, d0 >= 0, "
                         f"1 <= h <= {H}")
    return params


def carve_chunk_resident_batched(cur_b, cur_bias, cur_rig, posmap, w0, d0,
                                 kc, h, rigc, delta_x: int, has_bias: bool,
                                 has_rig: bool, nrg: int, ssf: int, KC: int):
    """Carve kc[i] <= KC seams off every map i of a [B, H, Wb] batch, at
    width w0[i], depth d0[i] and true height h[i] (each a host int or a
    sequence of B), with the rigidity coefficients rigc [B, delta_x + 1]
    f32 on the planes' device. Returns (hist [B, KC, H] i32, cur_b',
    cur_bias', cur_rig', posmap') as carve_chunk_resident does per map."""
    if cur_b.ndim != 3:
        raise ValueError(f"cur_b: expected [B, H, Wb], got "
                         f"{tuple(cur_b.shape)}")
    B, H, Wb = cur_b.shape
    _check_args(cur_b[0], None if cur_bias is None else cur_bias[0],
                None if cur_rig is None else cur_rig[0], posmap[0], Wb, 0, 0,
                delta_x, has_bias, has_rig, nrg, KC)
    shape, dev = (B, H, Wb), cur_b.device
    for name, t in (("cur_b", cur_b), ("posmap", posmap),
                    ("cur_bias", cur_bias if has_bias else None),
                    ("cur_rig", cur_rig if has_rig else None)):
        if t is not None:
            dp_cuda._check(t, name, t.dtype, shape, dev)
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
    params_d = params.to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lqr_carve_resident_batched(
            b.data_ptr(), bias.data_ptr() if has_bias else None,
            rig.data_ptr() if has_rig else None, pm.data_ptr(),
            e.data_ptr(), bp.data_ptr(), seam.data_ptr(), hist.data_ptr(),
            rigc.data_ptr(), params_d.data_ptr(), B, H, Wp, int(KC),
            delta_x, nrg, int(ssf), *geo, stream)
    _build.check(lib, rc, "lqr_carve_resident_batched")
    dp_cuda.LAUNCHES["carve_resident_batched"] += 1
    BATCH_BLOCKS[str(geo[0])] += 1
    return (hist, _cut(b, Wb), _cut(bias, Wb) if has_bias else bias,
            _cut(rig, Wb) if has_rig else rig, _cut(pm, Wb))


def carve_chunk_resident_batched_plain(cur_b, cur_bias, cur_rig, posmap,
                                       params, rigc, delta_x: int,
                                       has_bias: bool, has_rig: bool,
                                       nrg: int, ssf: int, KC: int):
    """The plain version of the batched entry, on any device: the loop over
    the maps of carve_chunk_resident_plain. params: [B, 4] i32 rows
    [w0, d0, kc, h] (host)."""
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
