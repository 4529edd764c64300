"""The carver engine: seam step, map extension, materialization (PyTorch).

Counterpart of ``lqr_tpu.core.engine``. ``extend_map`` takes one of two
routes, as the JAX engine does:

- the resident route, where ``ops.carve_resident.resident_ok`` admits the
  map: ``extend_resident``, the route of a batch of maps (a solo map is a
  batch of one, ``state.batch_of_one``; ``parallel.batch.extend_batched``
  takes it at its batch size): chunks of KC seams, each carved by one
  launch of the resident kernel for the whole batch, whose seams come back
  as reference columns and go into ``vs`` by one scatter per chunk;
- the per-seam route otherwise, one seam at a time as below.

One seam on the compacted state:

- energy = gradients of the carried reader plane ``cur_b`` (+ bias);
- DP + backtrack through ``ops.dp_cuda`` (CUDA kernels on a CUDA tensor,
  their plain versions on a CPU tensor);
- compaction by roll/select: removing column s of a row is
  ``where(lane >= s, shift_left(row), row)``;
- the seam is recorded straight into ``vs``: a compacted ``posmap`` plane
  (compacted column -> reference column) rides the same compaction, so
  seam s of row y lands at ``vs[y, posmap[y, seam[y]]] = s``. This gives
  the JAX engine's ``vs`` without its chunked one-hot commit, which exists
  only because scatters serialize on a TPU.

``ref_w`` and ``depth`` are host ints, so the seam loop never waits for the
device. Materialization (SPEC.md §6) places pixels with cumsum destinations
and a scatter, in place of the JAX engine's sort, over a batch of maps
at once (one map is a batch of one).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .state import (EngineConfig, MapState, batch_of_one, image_state,
                    per_map)
from .energy import energy_from_plane
from ..ops import dp_cuda
from ..profiling import annotate, count
from ..ops.carve_resident import carve_chunk_resident_batched, resident_ok

# seams per resident chunk: one kernel launch and one vs scatter each
KC = 128


def pref_is_left(s: int, freq: int) -> bool:
    """Side preference of the 1-based seam index s (SPEC.md §5)."""
    if freq <= 0:
        return True
    return ((s - 1) // freq) % 2 == 0


def _lane(Wb: int, device) -> torch.Tensor:
    return torch.arange(Wb, dtype=torch.int32, device=device)[None, :]


def _posmap(vs: torch.Tensor, ref_w) -> torch.Tensor:
    """posmap[..., y, r] = reference column of the r-th visible pixel of
    row y, then the hidden columns in order (the stable argsort of the
    hidden flags, as a cumsum and one scatter): of one map (vs [H, Wb],
    ref_w a host int) or of each map of a batch (vs [B, H, Wb], ref_w as
    ``state.per_map`` gives the maps' widths)."""
    lane = torch.arange(vs.shape[-1], dtype=torch.int32, device=vs.device)
    visible = (vs == 0) & (lane < ref_w)
    c = torch.cumsum(visible, dim=-1)         # visible columns up to x
    dest = torch.where(visible, c - 1, c[..., -1:] + lane - c)
    pm = torch.empty_like(vs)
    return pm.scatter_(-1, dest, lane.expand(vs.shape))


def total_energy(cur_b, cur_bias, w: int, nrg: int, has_bias: bool,
                 h=None) -> torch.Tensor:
    """The DP's energy map [H, Wb] f32 of the compacted planes at width w:
    energy_from_plane plus the bias where present, +inf at lanes >= w."""
    e = energy_from_plane(cur_b, w, nrg, h=h)
    if has_bias:
        lane = _lane(cur_b.shape[1], cur_b.device)
        e = torch.where(lane < w, e + cur_bias, torch.inf)
    return e


def compactor(seam: torch.Tensor, w: int, Wb: int):
    """The roll/select compaction that removes column seam[y] of each row
    of a [H, Wb] plane at width w: a function of the plane, giving
    a[y, x + 1] at x >= seam[y], a[y, x] before it, and 0 at x >= w - 1."""
    lane = _lane(Wb, seam.device)
    ge = lane >= seam[:, None]
    keep = lane < (w - 1)

    def compact(a):
        out = torch.where(ge, torch.roll(a, -1, dims=1), a)
        return torch.where(keep, out, 0)

    return compact


def _carve_once(cfg: EngineConfig, cur_b, cur_bias, cur_rig, posmap,
                w: int, s: int, find_seam=dp_cuda.find_seam, h=None,
                rigc_vec=None):
    """Find seam s (1-based) on the compacted planes at width w and compact
    them. Returns (seam [H] i32, cur_b', cur_bias', cur_rig', posmap');
    posmap may be None (and then stays None). ``find_seam``: the kernels'
    wrapper, or ``dp_cuda.find_seam_plain`` for the resident kernel's plain
    version. h / rigc_vec: the true height and rigidity coefficients of a
    map padded to more rows (ragged batches; see core.dp)."""
    pl = pref_is_left(s, cfg.side_switch_freq)
    with annotate("seam.energy"):
        e = total_energy(cur_b, cur_bias, w, cfg.nrg, cfg.has_bias, h=h)
    with annotate("seam.find"):
        seam = find_seam(e, cur_rig, pl, cfg.delta_x, cfg.has_rig, h=h,
                         rigc_vec=rigc_vec)
    with annotate("seam.compact"):
        compact = compactor(seam, w, cfg.Wb)
        cur_b = compact(cur_b)
        if cfg.has_bias:
            cur_bias = compact(cur_bias)
        if cfg.has_rig:
            cur_rig = compact(cur_rig)
        if posmap is not None:
            posmap = compact(posmap)
    return seam, cur_b, cur_bias, cur_rig, posmap


def route(cfg: EngineConfig) -> str:
    """The route extend_map takes for a map of this config: "resident"
    (planes within ``RESIDENT_BUDGET``) or "per_seam"."""
    if resident_ok(1, cfg.H, cfg.Wb, cfg.has_bias, cfg.has_rig):
        return "resident"
    return "per_seam"


def extend_map(cfg: EngineConfig, st: MapState, k: int) -> MapState:
    """Carve k further seams into the map (depth += k).

    The returned state owns a fresh ``vs`` (the input state is left
    unchanged); seams are written into it in place as they are found.
    Both routes give the same state, bit for bit. Each call is the span
    ``engine.<route>``, adds k to the counter ``seams.<route>`` and its
    host time (issue, and any wait the route has) to ``route_ns.<route>``,
    traced or not."""
    name = route(cfg)
    t0 = time.perf_counter_ns()
    with annotate("engine." + name):
        if name == "resident":
            rigc = dp_cuda._rigc_device(cfg.delta_x, cfg.H, st.vs.device)
            st = image_state(extend_resident(
                cfg, batch_of_one(st), np.array([k], np.int64), cfg.H,
                rigc[None]), 0)
        else:
            st = _extend_per_seam(cfg, st, k)
    count("route_ns." + name, time.perf_counter_ns() - t0)
    count("seams." + name, int(k))
    return st


def extend_resident(cfg: EngineConfig, st: MapState, k, h,
                    rigc: torch.Tensor) -> MapState:
    """Carve k[b] further seams into each map of a batched state (k: [B]
    host ints) through the resident kernel: chunks of KC seams counted
    from this call, each one launch for the whole batch (the span
    ``resident.chunk``) committed to vs by one scatter
    (``resident.commit``). h: the maps' true heights (a host int, or [B]);
    rigc: their rigidity coefficients [B, delta_x + 1] f32 on the planes'
    device. The returned state owns a fresh vs."""
    B, H, Wb = st.vs.shape
    dev = st.vs.device
    # vs lives in a buffer one element longer: a -1 history entry (past a
    # map's kc) commits to that last element, which nothing reads
    vs_buf = torch.empty(B * H * Wb + 1, dtype=torch.int32, device=dev)
    vs = vs_buf[:-1].view(B, H, Wb)
    vs.copy_(st.vs)
    pm = _posmap(vs, per_map(st.ref_w, dev))
    d0 = per_map(st.depth, dev)
    cur_b, cur_bias, cur_rig = st.cur_b, st.cur_bias, st.cur_rig
    depth = st.depth.copy()
    done, kmax = 0, int(k.max()) if B else 0
    while done < kmax:
        kc = np.clip(k - done, 0, KC)
        with annotate("resident.chunk"):
            hist, cur_b, cur_bias, cur_rig, pm = carve_chunk_resident_batched(
                cur_b, cur_bias, cur_rig, pm, st.ref_w - depth, depth, kc, h,
                rigc, cfg.delta_x, cfg.has_bias, cfg.has_rig, cfg.nrg,
                cfg.side_switch_freq, KC)
        with annotate("resident.commit"):
            # seam j of the chunk is seam d0 + done + j + 1 of its map (a
            # map that has carved all its seams records none)
            ids = (torch.arange(done + 1, done + KC + 1, device=dev)
                   .view(1, KC, 1) + d0).to(torch.int32)
            base = torch.arange(B * H, device=dev).view(B, 1, H) * Wb
            idx = torch.where(hist >= 0, base + hist, B * H * Wb)
            vs_buf.scatter_(0, idx.reshape(-1),
                            ids.expand(B, KC, H).reshape(-1))
        depth += kc
        done += KC
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


def _extend_per_seam(cfg: EngineConfig, st: MapState, k: int, h=None,
                     rigc_vec=None) -> MapState:
    """extend_map one seam at a time, through the DP and backtrack
    kernels. h / rigc_vec: as for _carve_once."""
    vs = st.vs.clone()
    posmap = _posmap(vs, st.ref_w)
    cur_b, cur_bias, cur_rig = st.cur_b, st.cur_bias, st.cur_rig
    depth = st.depth
    for _ in range(int(k)):
        s = depth + 1
        with annotate("engine.seam"):
            seam, cur_b, cur_bias, cur_rig, pm_next = _carve_once(
                cfg, cur_b, cur_bias, cur_rig, posmap, st.ref_w - depth, s,
                h=h, rigc_vec=rigc_vec)
            with annotate("seam.commit"):
                ref_col = posmap.gather(1, seam[:, None].long()).long()
                vs.scatter_(1, ref_col, s)
        posmap = pm_next
        depth = s
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


def _commit_hist(vs: torch.Tensor, ref_w: int, d0: int, kc: int,
                 hist: torch.Tensor) -> None:
    """Commit a chunk's seam history into vs in place, as
    lqr_tpu.core.engine._commit_hist does: hist[j] ([H]) is seam d0+j+1 in
    the coordinates of frame d0+j (the image with d0+j seams removed).
    Composing the removals (position c of frame j+1 is c + (c >= hist[j])
    of frame j) gives each seam's rank among the visible reference columns
    of frame d0, which posmap lifts to its reference column."""
    if kc == 0:
        return
    R = hist[:kc].clone()
    for jr in range(kc - 2, -1, -1):
        R[jr + 1:] += (R[jr + 1:] >= hist[jr]).to(torch.int32)
    cols = _posmap(vs, ref_w).gather(1, R.t().long())     # [H, kc]
    ids = torch.arange(d0 + 1, d0 + kc + 1, dtype=torch.int32,
                       device=vs.device)
    vs.scatter_(1, cols.long(), ids[None, :].expand(vs.shape[0], kc))


def seam_step(cfg: EngineConfig, st: MapState) -> MapState:
    """Carve one more seam into the map (depth += 1)."""
    return extend_map(cfg, st, 1)


# ---------------------------------------------------------------------------
# materialization (SPEC.md §6)
# ---------------------------------------------------------------------------

def _avg_insert(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Value of a pixel inserted between a and b (floor average for u8)."""
    if a.dtype == torch.uint8:
        return torch.div(a.to(torch.int16) + b.to(torch.int16), 2,
                         rounding_mode="floor").to(torch.uint8)
    return (a + b) * 0.5


def _place(vals: torch.Tensor, dest: torch.Tensor, width: int):
    """out[b, y, dest[b, y, x]] = vals[b, y, x] for dest < width; the rest
    land in a drop column. vals: [B, H, W, C]; dest: [B, H, W] int64,
    clamped in place."""
    B, H, _, C = vals.shape
    out = vals.new_zeros((B, H, width + 1, C))
    out.scatter_(2, dest.clamp_(max=width)[..., None].expand(-1, -1, -1, C),
                 vals)
    return out[:, :, :width]


def _materialize(a: torch.Tensor, vs: torch.Tensor, ref_w: np.ndarray,
                 w: np.ndarray, out_Wb: int) -> torch.Tensor:
    """Apply each map's visibility map to its reference-coordinate array.

    a: [B, H, Wb, C]; vs: [B, H, Wb] i32; ref_w, w: [B] host ints. Returns
    [B, H, out_Wb, C] with lanes >= w[b] zeroed; requires |w - ref_w| <=
    depth. Each map keeps its pixels with vs == 0 or vs > ref_w - w, in
    column order, and after each pixel with 1 <= vs <= w - ref_w inserts
    the average of it and its right neighbour (the pixel itself at the
    edge): a map that shrinks inserts nothing, one that enlarges drops
    nothing, so a batch may mix the two.
    """
    B, H, Wb = vs.shape
    dev = vs.device
    lane = torch.arange(Wb, dtype=torch.int32, device=dev)
    rw, grow, w_d = (per_map(x, dev) for x in (ref_w, w - ref_w, w))
    valid = lane < rw
    keep = valid & ((vs == 0) | (vs > -grow))
    dest = torch.cumsum(keep, dim=2).sub_(1)
    if (w > ref_w).any():
        dup = valid & (vs >= 1) & (vs <= grow)
        dest += torch.cumsum(dup, dim=2).sub_(dup.to(torch.int64))
        nxt = torch.roll(a, -1, dims=2)
        nxt = torch.where((lane == rw - 1)[..., None], a, nxt)
        a = torch.cat([a, _avg_insert(a, nxt)], dim=2)
        dest = torch.cat([dest.masked_fill(~keep, out_Wb),
                          (dest + 1).masked_fill_(~dup, out_Wb)], dim=2)
    else:
        dest.masked_fill_(~keep, out_Wb)
    out = _place(a, dest, out_Wb)
    lane_out = torch.arange(out_Wb, dtype=torch.int32, device=dev)
    return torch.where((lane_out < w_d)[..., None], out, 0)


def materialize_array(arr: torch.Tensor, vs: torch.Tensor, ref_w, w,
                      out_Wb: int) -> torch.Tensor:
    """Apply a visibility map to one reference-coordinate array: arr
    [H, Wb] or [H, Wb, C], vs [H, Wb] i32, ref_w and w host ints; or to
    each map of a batch: arr [B, H, Wb(, C)], vs [B, H, Wb], ref_w and w
    [B] host ints. Returns [(B,) H, out_Wb(, C)] with lanes >= w zeroed
    (``_materialize``)."""
    one = vs.ndim == 2
    if one:
        arr, vs, ref_w, w = arr[None], vs[None], [ref_w], [w]
    has_c = arr.ndim == 4
    out = _materialize(arr if has_c else arr[..., None], vs,
                       np.asarray(ref_w, np.int64), np.asarray(w, np.int64),
                       out_Wb)
    out = out if has_c else out[..., 0]
    return out[0] if one else out


def materialize(cfg: EngineConfig, st: MapState, w: int,
                out_Wb: int) -> torch.Tensor:
    """Materialize the main image at width w -> u8 [H, out_Wb, C]."""
    return materialize_array(st.ref, st.vs, st.ref_w, w, out_Wb)


def materialize_all(cfg: EngineConfig, st: MapState, w: int, out_Wb: int):
    """Materialize main + bias + rig + aux at width w.

    Returns (img, bias, rig, aux_tuple); bias/rig are None when absent."""
    img = materialize_array(st.ref, st.vs, st.ref_w, w, out_Wb)
    bias = (materialize_array(st.bias, st.vs, st.ref_w, w, out_Wb)
            if st.bias is not None else None)
    rig = (materialize_array(st.rig, st.vs, st.ref_w, w, out_Wb)
           if st.rig is not None else None)
    aux = tuple(materialize_array(x, st.vs, st.ref_w, w, out_Wb)
                for x in st.aux)
    return img, bias, rig, aux
