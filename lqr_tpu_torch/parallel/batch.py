"""Batched carving: many maps carved together (PyTorch).

Counterpart of ``lqr_tpu.parallel.batch``. Ragged batches are padded to a
common [H, Wb] with per-image widths and heights. Padding is invisible:
lanes >= width get +inf energy, and rows >= height are pass-through rows of
the DP with the bottom edge replicated at the true height (core.dp,
core.energy), so each image's seams equal its solo carve. Per-image seam
counts may differ.

A batched ``MapState`` has a leading batch axis on every tensor, and its
``ref_w`` and ``depth`` are host int64 arrays [B] (the solo state's host
ints, one per image).

Both functions that carve a batch give one result, bit for bit:

- ``extend_map_batched``: the JAX function's flat loop over seams, each map
  carved by the engine's ``_carve_once`` and its seams committed to ``vs``
  once per chunk of KC (``engine._commit_hist``). It is the reference the
  routes below are held to.
- ``extend_batched``, the route ``BatchCarver`` takes: chunks of KC seams,
  each one launch of the batched resident kernel (one thread block per map)
  where ``ops.carve_resident.batched_resident_ok`` admits the batch, else
  the per-seam kernels map by map (``engine._extend_per_seam``). On CPU
  tensors both run their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dp
from ..core import engine as eng
from ..core.energy import reader_plane
from ..core.state import EngineConfig, MapState, resolve_device, round_up
from ..errors import LqrImageError
from ..i18n import _
from ..ops.carve_resident import (batched_resident_ok,
                                  carve_chunk_resident_batched)
from .sharding import (extend_map_sharded, gather_state, map_data_shards,
                       shard_batch_state)

__all__ = ["rigc_table", "init_state_batched", "extend_map_batched",
           "extend_batched", "materialize_batched", "materialize_all_batched",
           "BatchCarver"]


def rigc_table(heights, delta_x: int) -> np.ndarray:
    """Per-image rigidity step coefficients [B, delta_x + 1] f32:
    rigc[b, m] = f32(m^1.5 / h_b), computed in f64 and rounded once
    (SPEC.md §4), as core.dp.rigc_table computes one row."""
    return np.stack([dp.rigc_table(delta_x, int(h)) for h in heights])


def init_state_batched(cfg: EngineConfig, pixels, widths, bias=None,
                       rig=None, aux=(), device="cuda") -> MapState:
    """pixels: [B, H, Wb, C] u8, padded (lanes >= widths[b] and rows >=
    heights[b] zero); widths: [B]. bias/rig: [B, H, Wb] f32 (present iff
    the config has them); aux: tuple of [B, H, Wb, C_i] u8. Numpy arrays or
    tensors; everything lands on ``device``: the card by default
    (LqrConfigError without CUDA), the CPU when asked with
    ``device="cpu"``."""
    device = resolve_device(device)
    pixels = torch.as_tensor(pixels, dtype=torch.uint8, device=device)
    B, H, Wb, C = pixels.shape
    assert (H, Wb, C) == (cfg.H, cfg.Wb, cfg.C), (pixels.shape, cfg)

    def plane(a, flag, name):
        assert (a is not None) == flag, f"{name} presence vs cfg"
        return (None if a is None
                else torch.as_tensor(a, dtype=torch.float32, device=device))

    bias = plane(bias, cfg.has_bias, "bias")
    rig = plane(rig, cfg.has_rig, "rig")
    aux_p = tuple(torch.as_tensor(a, dtype=torch.uint8, device=device)
                  for a in aux)
    assert tuple(a.shape[3] for a in aux_p) == tuple(cfg.aux_channels)
    return MapState(
        ref=pixels, bias=bias, rig=rig,
        vs=torch.zeros((B, H, Wb), dtype=torch.int32, device=device),
        aux=aux_p, cur_b=reader_plane(pixels, cfg.nrg), cur_bias=bias,
        cur_rig=rig, ref_w=np.array(widths, np.int64).reshape(B),
        depth=np.zeros(B, np.int64))


def per_image(n, B: int) -> np.ndarray:
    """A scalar or [B] count as an int64 array [B]."""
    return np.broadcast_to(np.asarray(n, np.int64), (B,)).copy()


def image_state(st: MapState, i: int) -> MapState:
    """Map i of a batched state, as a solo state (views, host ints)."""
    def pick(a):
        return None if a is None else a[i]
    return MapState(ref=st.ref[i], bias=pick(st.bias), rig=pick(st.rig),
                    vs=st.vs[i], aux=tuple(a[i] for a in st.aux),
                    cur_b=st.cur_b[i], cur_bias=pick(st.cur_bias),
                    cur_rig=pick(st.cur_rig), ref_w=int(st.ref_w[i]),
                    depth=int(st.depth[i]))


def _stack(planes):
    return None if planes[0] is None else torch.stack(planes)


def _rigc(cfg: EngineConfig, heights, rigc, B: int,
          device) -> torch.Tensor:
    """The [B, delta_x + 1] f32 coefficients on the device: rigc as given,
    else rigc_table of the heights (None: every map is cfg.H rows)."""
    if rigc is None:
        rigc = rigc_table(np.full(B, cfg.H) if heights is None else heights,
                          cfg.delta_x)
    return torch.as_tensor(rigc, dtype=torch.float32, device=device)


def extend_map_batched(cfg: EngineConfig, st: MapState, k, heights=None,
                       rigc=None) -> MapState:
    """Carve k[b] further seams into each map (k: scalar or [B]): the flat
    loop over seams of lqr_tpu.parallel.batch.extend_map_batched.

    Step ``done`` carves one seam off every map with done < k[b]; the
    seams wait in a [B, KC, H] history of compacted columns, committed to
    ``vs`` every KC-th step and after the last. heights: [B] true heights
    (None: all rows real); rigc: [B, delta_x + 1] f32 per-image rigidity
    coefficients (``rigc_table``; None: zeros with heights, as in JAX)."""
    B, H = st.vs.shape[0], cfg.H
    k = per_image(k, B)
    kmax = int(k.max()) if B else 0
    dev = st.vs.device
    rc = None
    if heights is not None:
        rc = (torch.as_tensor(rigc, dtype=torch.float32, device=dev)
              if rigc is not None
              else torch.zeros((B, cfg.delta_x + 1), device=dev))
    cur_b = list(st.cur_b)
    cur_bias = list(st.cur_bias) if cfg.has_bias else [None] * B
    cur_rig = list(st.cur_rig) if cfg.has_rig else [None] * B
    vs = st.vs.clone()
    depth = st.depth.copy()
    chunk_d0 = depth.copy()
    hist = torch.zeros((B, eng.KC, H), dtype=torch.int32, device=dev)
    for done in range(kmax):
        j = done % eng.KC
        for i in np.flatnonzero(done < k):
            seam, cur_b[i], cur_bias[i], cur_rig[i], _ = eng._carve_once(
                cfg, cur_b[i], cur_bias[i], cur_rig[i], None,
                int(st.ref_w[i] - depth[i]), int(depth[i] + 1),
                h=None if heights is None else int(heights[i]),
                rigc_vec=None if rc is None else rc[i])
            hist[i, j] = seam
            depth[i] += 1
        if j + 1 == eng.KC or done + 1 >= kmax:
            for i in range(B):
                eng._commit_hist(vs[i], int(st.ref_w[i]), int(chunk_d0[i]),
                                 int(depth[i] - chunk_d0[i]), hist[i])
            chunk_d0 = depth.copy()
    return st._replace(vs=vs, cur_b=torch.stack(cur_b),
                       cur_bias=_stack(cur_bias) if cfg.has_bias
                       else st.cur_bias,
                       cur_rig=_stack(cur_rig) if cfg.has_rig
                       else st.cur_rig, depth=depth)


def _posmap_batched(vs: torch.Tensor, ref_w: np.ndarray) -> torch.Tensor:
    """posmap[b, y, r] = reference column of the r-th visible pixel of row
    y of map b, then the hidden columns in order: the stable argsort of
    engine._posmap_from_vs, as a cumsum and one scatter."""
    B, H, Wb = vs.shape
    lane = torch.arange(Wb, dtype=torch.int32, device=vs.device)
    rw = torch.from_numpy(ref_w).to(vs.device)[:, None, None]
    visible = (vs == 0) & (lane < rw)
    vis = visible.to(torch.int32)
    n_vis = vis.sum(dim=2, keepdim=True)
    dest = torch.where(visible, torch.cumsum(vis, dim=2) - 1,
                       n_vis + torch.cumsum(1 - vis, dim=2) - 1)
    pm = torch.empty_like(vs)
    pm.scatter_(2, dest.long(), lane.expand(B, H, Wb).contiguous())
    return pm


def _extend_resident(cfg: EngineConfig, st: MapState, k, heights=None,
                     rigc=None) -> MapState:
    """extend_batched's route through the batched resident kernel: chunks
    of KC seams counted from this call, each one launch for the whole
    batch, each committed to vs by one scatter."""
    B, H, Wb = st.vs.shape
    KC = eng.KC
    k = per_image(k, B)
    dev = st.vs.device
    h = np.full(B, H) if heights is None else np.asarray(heights)
    rc = _rigc(cfg, heights, rigc, B, dev)
    # vs lives in a buffer one element longer: a -1 history entry (past a
    # map's kc) commits to that last element, which nothing reads
    vs_buf = torch.empty(B * H * Wb + 1, dtype=torch.int32, device=dev)
    vs = vs_buf[:-1].view(B, H, Wb)
    vs.copy_(st.vs)
    pm = _posmap_batched(vs, st.ref_w)
    base = ((torch.arange(B, device=dev)[:, None, None] * H
             + torch.arange(H, device=dev)[None, None, :]) * Wb)
    jrow = torch.arange(KC, dtype=torch.int32, device=dev)[None, :, None]
    cur_b, cur_bias, cur_rig = st.cur_b, st.cur_bias, st.cur_rig
    depth = st.depth.copy()
    done, kmax = 0, int(k.max()) if B else 0
    while done < kmax:
        kc = np.clip(k - done, 0, KC)
        hist, cur_b, cur_bias, cur_rig, pm = carve_chunk_resident_batched(
            cur_b, cur_bias, cur_rig, pm, st.ref_w - depth, depth, kc, h,
            rc, cfg.delta_x, cfg.has_bias, cfg.has_rig, cfg.nrg,
            cfg.side_switch_freq, KC)
        idx = torch.where(hist >= 0, base + hist, B * H * Wb)
        ids = torch.from_numpy(depth).to(dev)[:, None, None] + 1 + jrow
        vs_buf.scatter_(0, idx.reshape(-1),
                        ids.to(torch.int32).expand(B, KC, H).reshape(-1))
        depth += kc
        done += KC
    return st._replace(vs=vs, cur_b=cur_b, cur_bias=cur_bias,
                       cur_rig=cur_rig, depth=depth)


def _extend_per_seam(cfg: EngineConfig, st: MapState, k, heights=None,
                     rigc=None) -> MapState:
    """extend_batched's route for batches the resident kernel refuses: the
    per-seam kernels, one map after the other."""
    B, H = st.vs.shape[:2]
    k = per_image(k, B)
    rc = _rigc(cfg, heights, rigc, B, st.vs.device)
    outs = []
    for i in range(B):
        h = None if heights is None or heights[i] == H else int(heights[i])
        outs.append(eng._extend_per_seam(cfg, image_state(st, i), int(k[i]),
                                         h=h, rigc_vec=rc[i]))
    return st._replace(
        vs=torch.stack([o.vs for o in outs]),
        cur_b=torch.stack([o.cur_b for o in outs]),
        cur_bias=_stack([o.cur_bias for o in outs]),
        cur_rig=_stack([o.cur_rig for o in outs]),
        depth=np.array([o.depth for o in outs], np.int64))


def extend_batched(cfg: EngineConfig, st: MapState, k, heights=None,
                   rigc=None) -> MapState:
    """Carve k[b] further seams into each map: the batched resident kernel
    where it admits the batch, else the per-seam kernels map by map. Both
    equal extend_map_batched bit for bit."""
    B, H, Wb = st.vs.shape
    if batched_resident_ok(B, H, Wb, cfg.has_bias, cfg.has_rig):
        return _extend_resident(cfg, st, k, heights, rigc)
    return _extend_per_seam(cfg, st, k, heights, rigc)


def materialize_batched(cfg: EngineConfig, st: MapState, w,
                        out_Wb: int) -> torch.Tensor:
    """Each image at width w[b] -> [B, H, out_Wb, C] u8."""
    w = per_image(w, st.vs.shape[0])
    return torch.stack([
        eng.materialize_array(st.ref[i], st.vs[i], int(st.ref_w[i]),
                              int(w[i]), out_Wb)
        for i in range(len(w))])


def materialize_all_batched(cfg: EngineConfig, st: MapState, w,
                            out_Wb: int):
    """Main image and every attached aux image at width w[b]: (img
    [B, H, out_Wb, C], aux tuple), the batched write_aux_carver."""
    w = per_image(w, st.vs.shape[0])

    def one(arr):
        return torch.stack([
            eng.materialize_array(arr[i], st.vs[i], int(st.ref_w[i]),
                                  int(w[i]), out_Wb)
            for i in range(len(w))])

    return one(st.ref), tuple(one(a) for a in st.aux)


class BatchCarver:
    """Host API for carving the widths of many images at once.

    Feature parity with the solo ``Carver``: per-image ``biases`` (energy
    bias fields), ``rigmasks`` with a global ``rigidity`` (SPEC.md §4), and
    ``aux`` images that follow the same seams. Height carving: transpose
    the inputs, as the solo Carver does.
    """

    def __init__(self, images, *, delta_x: int = 1, nrg: int = 0,
                 rigidity: float = 0.0, biases=None, rigmasks=None,
                 aux=None, mesh=None, device="cuda"):
        """images: a list of [h_i, w_i, C] u8 arrays (the same C; ragged
        sizes are padded, each image's seams equal its solo carve), or a
        pre-stacked [B, H, W, C] u8 ndarray of equal-size images whose lanes
        past the width are zero.

        biases / rigmasks: per-image f32 [h_i, w_i] fields or None entries
        (with rigidity > 0 and no mask, the global value applies
        everywhere); aux: per-image lists of [h_i, w_i, C_j] u8 images, the
        same count and channels for every image.

        mesh: a ``parallel.sharding.Mesh``. Its 'data' axis splits the
        batch; with a 'cols' axis of more than one device, image columns
        split too and ``carve`` runs the column-sharded resize (equal
        heights only). The state lives on the mesh's devices; without a
        mesh it lives on ``device``. On a mesh over processes
        (``make_process_mesh``) every process passes the same images and
        counts and carves the shard it holds (a column shard's seam steps
        with the other processes of its row); ``carve``, ``state``,
        ``images_at`` and ``aux_at`` are then collectives (every process
        calls them), the last three all-gathering the shards over the
        group."""
        if len(images) == 0:
            raise LqrImageError(_("BatchCarver needs at least one image"))
        if isinstance(images, np.ndarray) and images.ndim == 4:
            # a pre-stacked equal-size batch; a buffer already padded to
            # the lane bucket is used as it is
            if images.dtype != np.uint8:
                raise LqrImageError(
                    _("pre-stacked batch has dtype {dt}; expected uint8")
                    .format(dt=images.dtype))
            B, H, W, C = images.shape
            Wb = max(128, round_up(W, 128))
            if Wb == W:
                buf = np.ascontiguousarray(images)
            else:
                buf = np.zeros((B, H, Wb, C), np.uint8)
                buf[:, :, :W] = images
            widths = np.full((B,), W, np.int64)
            heights = np.full((B,), H, np.int64)
        else:
            C = images[0].shape[2] if images[0].ndim == 3 else 1
            H = max(im.shape[0] for im in images)
            Wmax = max(im.shape[1] for im in images)
            Wb = max(128, round_up(Wmax, 128))
            B = len(images)
            buf = np.zeros((B, H, Wb, C), np.uint8)
            widths = np.zeros((B,), np.int64)
            heights = np.zeros((B,), np.int64)
            for i, im in enumerate(images):
                if im.ndim == 2:
                    im = im[:, :, None]
                if im.shape[2] != C:
                    raise LqrImageError(
                        _("image {i} has {c} channels, batch has {C}")
                        .format(i=i, c=im.shape[2], C=C))
                h, w = im.shape[:2]
                buf[i, :h, :w] = im
                widths[i] = w
                heights[i] = h

        has_bias = biases is not None and any(b is not None for b in biases)
        has_rig = (rigidity > 0
                   or (rigmasks is not None
                       and any(r is not None for r in rigmasks)))

        def field(entries, fold_rigidity=False):
            out = np.zeros((B, H, Wb), np.float32)
            for i in range(B):
                e = None if entries is None else entries[i]
                h, w = heights[i], widths[i]
                if e is not None:
                    out[i, :h, :w] = np.asarray(e, np.float32)
                    if fold_rigidity:
                        out[i, :h, :w] *= np.float32(rigidity)
                elif fold_rigidity and rigidity > 0:
                    out[i, :h, :w] = np.float32(rigidity)
            return out

        bias_f = field(biases) if has_bias else None
        # per-pixel rigidity = global rigidity x mask strength, or the
        # global value alone where an image has no mask (SPEC.md §4)
        rig_f = field(rigmasks, fold_rigidity=True) if has_rig else None

        aux_planes, aux_channels = (), ()
        if aux is not None and any(a for a in aux):
            n_aux = len(aux[0])
            if any(len(a) != n_aux for a in aux):
                raise LqrImageError(
                    _("every image must attach the same number of aux "
                      "carvers"))
            planes, chans = [], []
            for j in range(n_aux):
                cj = aux[0][j].shape[2] if aux[0][j].ndim == 3 else 1
                pj = np.zeros((B, H, Wb, cj), np.uint8)
                for i in range(B):
                    a = np.asarray(aux[i][j], np.uint8)
                    if a.ndim == 2:
                        a = a[:, :, None]
                    if a.shape[:2] != (heights[i], widths[i]):
                        raise LqrImageError(
                            _("aux {j} of image {i} is {aw}x{ah}, image "
                              "is {w}x{h}")
                            .format(j=j, i=i, aw=a.shape[1], ah=a.shape[0],
                                    w=widths[i], h=heights[i]))
                    pj[i, :heights[i], :widths[i]] = a
                planes.append(pj)
                chans.append(cj)
            aux_planes, aux_channels = tuple(planes), tuple(chans)

        self.cfg = EngineConfig(H=H, Wb=Wb, C=C, delta_x=delta_x, nrg=nrg,
                                has_bias=has_bias, has_rig=has_rig,
                                aux_channels=aux_channels)
        self.heights = heights
        self.widths = widths
        # the ragged machinery only where heights differ
        self.ragged = bool((heights != H).any())
        self.mesh = mesh
        self.col_sharded = mesh is not None and mesh.shape["cols"] > 1
        if self.col_sharded and self.ragged:
            raise LqrImageError(
                _("column sharding requires equal image heights (pad or "
                  "batch same-height images together)"))
        if mesh is None:
            dev = resolve_device(device)
        else:
            d, c = mesh.local_shards[0]
            dev = mesh.devices[d][c]
        st = init_state_batched(self.cfg, buf, widths, bias=bias_f,
                                rig=rig_f, aux=aux_planes, device=dev)
        self._state = (st if mesh is None
                       else shard_batch_state(st, mesh,
                                              cols=self.col_sharded))

    @property
    def state(self) -> MapState:
        """The batched state; a sharded one gathered onto the mesh's first
        device (on a mesh over processes, onto this process's device)."""
        if self.mesh is None:
            return self._state
        return gather_state(self._state)

    def carve(self, n_seams):
        """Extend every map by n_seams (a scalar or one count per image)."""
        n = per_image(n_seams, len(self.widths))
        heights = self.heights if self.ragged else None
        if self.mesh is None:
            self._state = extend_batched(self.cfg, self._state, n, heights)
        elif self.col_sharded:
            self._state = extend_map_sharded(self.mesh, self.cfg,
                                             self._state, n)
        else:
            self._state = map_data_shards(
                self._state,
                lambda st, sl: extend_batched(
                    self.cfg, st, n[sl],
                    None if heights is None else heights[sl]))
        return self

    def images_at(self, new_widths):
        """Every image at the given widths (scalar or [B]): a list of
        [h_i, w_i, C] u8 arrays."""
        w = per_image(new_widths, len(self.widths))
        out = materialize_batched(self.cfg, self.state, w,
                                  self.cfg.Wb).cpu().numpy()
        return [out[i, :self.heights[i], :w[i]] for i in range(len(w))]

    def aux_at(self, new_widths):
        """Every attached aux image at the given widths: a per-image list
        of per-aux lists (the same seams, lqr_carver_attach)."""
        w = per_image(new_widths, len(self.widths))
        _img, aux = materialize_all_batched(self.cfg, self.state, w,
                                            self.cfg.Wb)
        aux = [a.cpu().numpy() for a in aux]
        return [[a[i, :self.heights[i], :w[i]] for a in aux]
                for i in range(len(w))]
