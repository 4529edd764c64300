"""The carver engine: seam step, map extension, materialization (PyTorch).

Counterpart of ``lqr_tpu.core.engine``. ``extend_map`` takes one of two
routes, as the JAX engine does:

- the resident route, where ``ops.carve_resident.resident_ok`` admits the
  map: chunks of KC seams, each carved by one launch of the resident
  kernel, whose seams come back as reference columns and go into ``vs`` by
  one scatter per chunk;
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
and a scatter, in place of the JAX engine's sort.
"""

from __future__ import annotations

import time

import torch

from .state import EngineConfig, MapState
from .energy import energy_from_plane
from ..ops import dp_cuda
from ..profiling import annotate, count
from ..ops.carve_resident import carve_chunk_resident, resident_ok

# seams per resident chunk: one kernel launch and one vs scatter each
KC = 128


def pref_is_left(s: int, freq: int) -> bool:
    """Side preference of the 1-based seam index s (SPEC.md §5)."""
    if freq <= 0:
        return True
    return ((s - 1) // freq) % 2 == 0


def _lane(Wb: int, device) -> torch.Tensor:
    return torch.arange(Wb, dtype=torch.int32, device=device)[None, :]


def _posmap_from_vs(vs: torch.Tensor, ref_w: int) -> torch.Tensor:
    """posmap[y, r] = reference column of the r-th visible pixel of row y
    (entries past the row's visible count are don't-care)."""
    H, Wb = vs.shape
    visible = (vs == 0) & (_lane(Wb, vs.device) < ref_w)
    hidden = (~visible).to(torch.uint8)
    return torch.argsort(hidden, dim=1, stable=True).to(torch.int32)


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
    if resident_ok(cfg.H, cfg.Wb, cfg.has_bias, cfg.has_rig):
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
            st = _extend_resident(cfg, st, k)
        else:
            st = _extend_per_seam(cfg, st, k)
    count("route_ns." + name, time.perf_counter_ns() - t0)
    count("seams." + name, int(k))
    return st


def _commit_ref_hist(vs: torch.Tensor, d0: int, kc: int,
                     hist: torch.Tensor) -> None:
    """Write seam ids d0+1 .. d0+kc into vs in place at the reference
    columns hist[:kc] ([kc, H]): one scatter, every index distinct within
    a row."""
    ids = torch.arange(d0 + 1, d0 + kc + 1, dtype=torch.int32,
                       device=vs.device)
    vs.scatter_(1, hist[:kc].t().long(), ids[None, :].expand(vs.shape[0], kc))


def _extend_resident(cfg: EngineConfig, st: MapState, k: int) -> MapState:
    """extend_map in chunks of KC seams, one resident launch each (chunks
    count from the start of this call, as in the JAX engine)."""
    vs = st.vs.clone()
    posmap = _posmap_from_vs(vs, st.ref_w)
    cur_b, cur_bias, cur_rig = st.cur_b, st.cur_bias, st.cur_rig
    depth, done = st.depth, 0
    while done < k:
        kc = min(KC, k - done)
        with annotate("resident.chunk"):
            hist, cur_b, cur_bias, cur_rig, posmap = carve_chunk_resident(
                cur_b, cur_bias, cur_rig, posmap, st.ref_w - depth, depth,
                kc, cfg.delta_x, cfg.has_bias, cfg.has_rig, cfg.nrg,
                cfg.side_switch_freq, KC)
        with annotate("resident.commit"):
            _commit_ref_hist(vs, depth, kc, hist)
        depth += kc
        done += kc
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


def _extend_per_seam(cfg: EngineConfig, st: MapState, k: int, h=None,
                     rigc_vec=None) -> MapState:
    """extend_map one seam at a time, through the DP and backtrack
    kernels. h / rigc_vec: as for _carve_once."""
    vs = st.vs.clone()
    posmap = _posmap_from_vs(vs, st.ref_w)
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
    cols = _posmap_from_vs(vs, ref_w).gather(1, R.t().long())     # [H, kc]
    _commit_ref_hist(vs, d0, kc, cols.t())


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
    """out[y, dest[y, x]] = vals[y, x] for dest < width; larger dests land
    in a drop column. vals: [H, W, C]."""
    H, _, C = vals.shape
    dest = dest.clamp(max=width).long()
    out = vals.new_zeros((H, width + 1, C))
    out.scatter_(1, dest[:, :, None].expand(-1, -1, C), vals)
    return out[:, :width]


def materialize_array(arr: torch.Tensor, vs: torch.Tensor, ref_w: int,
                      w: int, out_Wb: int) -> torch.Tensor:
    """Apply a visibility map to one reference-coordinate array.

    arr: [H, Wb] or [H, Wb, C]; vs: [H, Wb] i32. Returns [H, out_Wb(,C)]
    with lanes >= w zeroed; requires |w - ref_w| <= depth.

    shrink: keep pixels with vs == 0 or vs > ref_w - w, in column order.
    enlarge: after each pixel with 1 <= vs <= w - ref_w, insert the
    average of it and its right neighbour (the pixel itself at the edge).
    """
    H, Wb = vs.shape
    lane = _lane(Wb, vs.device)
    has_c = arr.ndim == 3
    a = arr if has_c else arr[:, :, None]
    if w <= ref_w:
        k = ref_w - w
        keep = ((vs == 0) | (vs > k)) & (lane < ref_w)
        dest = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        out = _place(a, torch.where(keep, dest, out_Wb), out_Wb)
    else:
        k = w - ref_w
        valid = lane < ref_w
        dup = valid & (vs >= 1) & (vs <= k)
        pos = lane + torch.cumsum(dup.to(torch.int32), dim=1) - dup.to(
            torch.int32)                 # destination of each original
        nxt = torch.roll(a, -1, dims=1)
        nxt = torch.where((lane == ref_w - 1)[:, :, None], a, nxt)
        ins = _avg_insert(a, nxt)
        vals = torch.cat([a, ins], dim=1)
        dest = torch.cat([torch.where(valid, pos, out_Wb),
                          torch.where(dup, pos + 1, out_Wb)], dim=1)
        out = _place(vals, dest, out_Wb)
    out = torch.where((_lane(out_Wb, vs.device) < w)[:, :, None], out, 0)
    return out if has_c else out[:, :, 0]


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
