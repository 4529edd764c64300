"""The ``Carver`` host API on PyTorch: liblqr's carver surface.

Counterpart of ``lqr_tpu.carver``: construction (``delta_x``,
``rigidity``), the setters, preservation/discard masks (``bias_add``),
rigidity masks (``rigmask_add``), attached aux images (``attach``,
``get_aux``), ``resize`` with orientation by transpose and multi-pass
enlargement, ``flatten``, ``get_image``/``get_image_device``, the
visibility-map dump and the introspection properties.

The device is explicit: ``device="cuda"`` (the default) runs the carving
kernels and raises when CUDA is absent; ``device="cpu"`` runs their plain
versions. Pixel data stays on the device; only ``get_image``, ``get_aux``
and ``vmap_dump`` copy to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (EnergyFunc, ResizeOrder, DEFAULT_SIDE_SWITCH_FREQUENCY,
                     MAX_DELTA_X, MAX_ENL_STEP, MIN_ENL_STEP)
from .errors import (LqrConfigError, LqrImageError, LqrStateError,
                     check_channels)
from .core.state import (EngineConfig, init_state, resolve_device,
                         round_up)
from .core import engine as eng
from .i18n import _
from .oracle import strength
from .ops.place_mask import place_mask
from .profiling import annotate, count


@dataclasses.dataclass
class VMap:
    """A recorded visibility map.

    ``data`` is [ref_h, ref_w] int32 in image (non-transposed) coordinates;
    value 0 = never carved, s in 1..depth = seam order. ``orientation``:
    0 = vertical seams (width resize), 1 = horizontal seams.
    """

    data: np.ndarray
    depth: int
    ref_w: int
    ref_h: int
    orientation: int


def _bucket(w: int) -> int:
    return max(128, round_up(w, 128))


def place_mask_numpy(mask: np.ndarray, H: int, W: int, x_off: int,
                     y_off: int) -> np.ndarray:
    """Strength field [H, W] f32 of a mask placed at (x_off, y_off) on the
    image, clipped to it (SPEC.md §3): the NumPy form of
    ``ops.place_mask`` and of lqr_tpu's ``codec.place_mask``, which the
    tests hold it equal to."""
    s = strength(mask)
    field = np.zeros((H, W), np.float32)
    hm, wm = s.shape
    y0, y1 = max(0, y_off), min(H, y_off + hm)
    x0, x1 = max(0, x_off), min(W, x_off + wm)
    if y1 > y0 and x1 > x0:
        field[y0:y1, x0:x1] = s[y0 - y_off:y1 - y_off, x0 - x_off:x1 - x_off]
    return field


class Carver:
    """A carver over an [H, W, C] uint8 image (C in 1..4)."""

    def __init__(self, pixels: np.ndarray, delta_x: int = 1,
                 rigidity: float = 0.0, device="cuda"):
        with annotate("carver.init"):
            pixels = np.ascontiguousarray(np.asarray(pixels, np.uint8))
            if pixels.ndim == 2:
                pixels = pixels[:, :, None]
            h, w, c = pixels.shape
            check_channels(c)
            if not 0 <= int(delta_x) <= MAX_DELTA_X:
                raise LqrConfigError(
                    _("delta_x={v} out of range 0..{hi}")
                    .format(v=delta_x, hi=MAX_DELTA_X))
            if rigidity < 0:
                raise LqrConfigError(
                    _("rigidity={v} must be >= 0").format(v=rigidity))
            self.device = resolve_device(device)
            self.delta_x = int(delta_x)
            self.rigidity = float(rigidity)
            self.nrg = EnergyFunc.GRAD_XABS
            self.res_order = ResizeOrder.HOR
            self.side_switch_freq = DEFAULT_SIDE_SWITCH_FREQUENCY
            self.enl_step = 1.5
            self.dump_vmaps = False
            self.progress = None

            self._C = c
            # reference arrays, image orientation ([h, w] layout)
            with annotate("carver.upload"):    # a copy
                self._ref_img = torch.tensor(pixels, device=self.device)
            count("bytes.h2d", pixels.nbytes)
            self._ref_bias = None               # f32 [h, w] or None
            self._ref_rig = None                # f32 [h, w] or None
            self._aux: list[torch.Tensor] = []  # u8 [h, w, C_i]
            self._ref_w, self._ref_h = w, h
            self._w, self._h = w, h             # current materialized size
            # live map
            self._state = None
            self._cfg: EngineConfig | None = None
            self._orientation = 0
            self._vmaps: list[VMap] = []

    # -- liblqr setters -----------------------------------------------------

    def set_energy_function(self, nrg: EnergyFunc):
        self._drop_map()
        self.nrg = EnergyFunc(nrg)

    def set_resize_order(self, order: ResizeOrder):
        self.res_order = ResizeOrder(order)

    def set_side_switch_frequency(self, f: int):
        self.side_switch_freq = int(f)

    def set_enl_step(self, step: float):
        if not MIN_ENL_STEP <= step <= MAX_ENL_STEP:
            raise LqrConfigError(
                _("enl_step={v} out of range [{lo}, {hi}] (100.1%-200%)")
                .format(v=step, lo=MIN_ENL_STEP, hi=MAX_ENL_STEP))
        self.enl_step = float(step)

    def set_dump_vmaps(self, flag: bool = True):
        self.dump_vmaps = bool(flag)

    def set_progress(self, progress):
        """progress: object with .init(msg), .update(frac), .end()."""
        self.progress = progress

    # -- masks --------------------------------------------------------------

    def bias_add(self, mask: np.ndarray, factor: float,
                 x_off: int = 0, y_off: int = 0):
        """lqr_carver_bias_add_rgb_area (SPEC.md §3). mask: [hm, wm(,C)] u8
        placed at (x_off, y_off) relative to the image; adds
        strength * factor/1000 to the energy bias of overlapping pixels
        (a preservation mask for factor > 0, a discard mask for < 0)."""
        self._flatten_if_carved()
        with annotate("carver.bias_add"):
            # f32(factor/1000): the f64 quotient rounded once, as lqr_tpu
            # does
            self._ref_bias = self._place_mask(
                mask, x_off, y_off, np.float32(float(factor) / 1000.0),
                self._ref_bias)
        self._drop_map()

    def rigmask_add(self, mask: np.ndarray, x_off: int = 0, y_off: int = 0):
        """lqr_carver_rigmask_add_rgb_area (SPEC.md §4): per-pixel rigidity
        multiplier = mask strength (0 outside the mask area)."""
        self._flatten_if_carved()
        self._ref_rig = self._place_mask(mask, x_off, y_off, np.float32(1.0),
                                         self._ref_rig)
        self._drop_map()

    def _place_mask(self, mask, x_off, y_off, f, prev) -> torch.Tensor:
        """prev (None: nothing) + f times the mask's strength field on the
        image: the u8 mask copied to the device as it is, and the plane
        built there by ``ops.place_mask``, equal bit for bit to
        ``place_mask_numpy(...) * f`` (+ prev)."""
        with annotate("carver.place_mask"):
            m = np.ascontiguousarray(np.asarray(mask, np.uint8))
            if m.ndim == 2:
                m = m[:, :, None]
            if m.ndim != 3 or not 1 <= m.shape[2] <= 4:
                raise LqrImageError(
                    _("{what} has shape {shape}; expected [h, w] or [h, w, "
                      "c] with 1-4 channels").format(what="mask",
                                                     shape=m.shape))
            with annotate("mask.copy"):
                dev_mask = torch.tensor(m, device=self.device)   # a copy
            with annotate("mask.place"):
                out = place_mask(dev_mask, self._ref_h, self._ref_w,
                                 int(x_off), int(y_off), f, prev)
        count("bytes.h2d", m.nbytes)
        return out

    # -- aux carvers --------------------------------------------------------

    def attach(self, aux_pixels: np.ndarray):
        """lqr_carver_attach: an aux image (same h, w; 1-4 channels) that
        undergoes the identical seam sequence."""
        self._flatten_if_carved()
        a = np.asarray(aux_pixels, np.uint8)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.shape[:2] != (self._ref_h, self._ref_w):
            raise LqrImageError(
                _("attached aux carver is {aw}x{ah}, main image is "
                  "{w}x{h}; attached carvers must match the main size")
                .format(aw=a.shape[1], ah=a.shape[0], w=self._ref_w,
                        h=self._ref_h))
        check_channels(a.shape[2], "aux carver")
        self._aux.append(torch.tensor(a, device=self.device))   # a copy
        count("bytes.h2d", a.nbytes)
        self._drop_map()

    # -- map plumbing -------------------------------------------------------

    def _drop_map(self):
        """Invalidate an uncarved map so config changes take effect."""
        if self._state is not None and self._state.depth:
            raise LqrStateError(
                _("internal: dropping a map with carved seams — this is "
                  "a bug; callers must flatten first"))
        self._state = None
        self._cfg = None

    def _flatten_if_carved(self):
        if self._state is not None and self._state.depth:
            self.flatten()

    def _local_dims(self, orientation):
        if orientation == 0:
            return self._ref_h, self._ref_w
        return self._ref_w, self._ref_h

    def _build_map(self, orientation: int):
        """Create a fresh MapState in the given orientation."""
        with annotate("carver.build_map"):
            H, W = self._local_dims(orientation)
            img, bias, rig = self._ref_img, self._ref_bias, self._ref_rig
            aux = list(self._aux)
            if orientation == 1:
                img = img.transpose(0, 1)
                bias = None if bias is None else bias.transpose(0, 1)
                rig = None if rig is None else rig.transpose(0, 1)
                aux = [a.transpose(0, 1) for a in aux]
            cfg = EngineConfig(
                H=H, Wb=_bucket(W), C=self._C, delta_x=self.delta_x,
                nrg=int(self.nrg), side_switch_freq=self.side_switch_freq,
                aux_channels=tuple(a.shape[2] for a in aux),
                has_bias=bias is not None,
                has_rig=rig is not None or self.rigidity > 0,
            )
            rig_field = None
            if cfg.has_rig:
                # per-pixel rigidity = global rigidity x mask strength, or
                # the global rigidity alone (SPEC.md §4)
                rigidity = torch.tensor(np.float32(self.rigidity))
                if rig is not None:
                    rig_field = rig * rigidity
                else:
                    rig_field = torch.full((H, W), np.float32(self.rigidity),
                                           dtype=torch.float32,
                                           device=self.device)
            self._state = init_state(cfg, img, bias=bias, rig=rig_field,
                                     aux=aux, device=self.device)
            self._cfg = cfg
            self._orientation = orientation

    def _ensure_map(self, orientation: int):
        if self._state is not None and self._orientation == orientation:
            return
        if self._state is not None:
            self.flatten()
        self._build_map(orientation)

    def _record_vmap(self):
        """Snapshot the live map as a VMap (lqr_vmap_dump semantics)."""
        if self._state is None or self._state.depth == 0:
            return None
        H, W = self._local_dims(self._orientation)
        vs = self._state.vs[:, :W].cpu().numpy()
        count("bytes.d2h", vs.nbytes)
        # a copy: the live map must not change with the caller's array
        vs = np.array(vs.T if self._orientation == 1 else vs)
        vm = VMap(data=vs, depth=self._state.depth, ref_w=self._ref_w,
                  ref_h=self._ref_h, orientation=self._orientation)
        self._vmaps.append(vm)
        return vm

    # -- core ops -----------------------------------------------------------

    def _extend(self, need_depth: int):
        """Extend the live map to depth >= need_depth."""
        depth = self._state.depth
        k = need_depth - depth
        if k <= 0:
            return
        prog = self.progress
        if prog is None:
            self._state = eng.extend_map(self._cfg, self._state, k)
            return
        prog.init(_("Resizing width...") if self._orientation == 0
                  else _("Resizing height..."))
        chunks = max(1, min(k, 20))
        base = k // chunks
        done = 0
        for i in range(chunks):
            step = base + (1 if i < k % chunks else 0)
            if step == 0:
                continue
            # publish the state per chunk: a raising progress callback
            # leaves the carver consistent at chunk granularity
            self._state = eng.extend_map(self._cfg, self._state, step)
            done += step
            prog.update(done / k)
        prog.end()

    def _resize_axis(self, orientation: int, target: int):
        """Resize the axis carved by the given orientation to target."""
        cur = self._w if orientation == 0 else self._h
        if target == cur:
            return
        if target < 1:
            raise LqrConfigError(
                _("target {axis} {v} is invalid; must be >= 1")
                .format(axis=_("width") if orientation == 0
                        else _("height"), v=target))
        while True:
            self._ensure_map(orientation)
            ref = self._ref_w if orientation == 0 else self._ref_h
            if target <= ref:
                self._extend(ref - target)
                self._set_cur(orientation, target)
                return
            # enlargement, possibly multi-pass (SPEC.md §7)
            cap = max(ref + 1, int(ref * self.enl_step))
            pass_target = min(target, cap)
            k = min(pass_target - ref, ref - 1)
            pass_target = ref + k
            self._extend(k)
            self._set_cur(orientation, pass_target)
            if pass_target == target:
                return
            if self.dump_vmaps:
                # one visibility map per resize pass, as liblqr records
                self._record_vmap()
            self.flatten()   # restart for the next enlargement pass

    def _set_cur(self, orientation, v):
        if orientation == 0:
            self._w = v
        else:
            self._h = v

    def resize(self, width: int, height: int):
        """lqr_carver_resize: carve/insert to (width, height), axes in
        res_order."""
        order = [0, 1] if self.res_order == ResizeOrder.HOR else [1, 0]
        with annotate("carver.resize"):
            for orientation in order:
                target = width if orientation == 0 else height
                before = self._w if orientation == 0 else self._h
                self._resize_axis(orientation, target)
                if self.dump_vmaps and target != before:
                    self._record_vmap()

    def _materialize(self):
        """(img, bias, rig, aux list) at the current size, image
        orientation, each cut to the current width; bias/rig are None when
        absent. Without a live map: the reference arrays."""
        with annotate("carver.materialize"):
            st, cfg = self._state, self._cfg
            if st is None:
                return (self._ref_img, self._ref_bias, self._ref_rig,
                        list(self._aux))
            w_local = self._w if self._orientation == 0 else self._h
            out_Wb = _bucket(max(w_local, st.ref_w))
            img, bias, rig, aux = eng.materialize_all(cfg, st, w_local,
                                                      out_Wb)
            planes = [img, bias, rig, *aux]
            planes = [None if p is None else p[:, :w_local] for p in planes]
            if self._orientation == 1:
                planes = [None if p is None else p.transpose(0, 1)
                          for p in planes]
            img, bias, rig, *aux = planes
            return img.contiguous(), bias, rig, aux

    def flatten(self):
        """lqr_carver_flatten: the current size becomes the new reference."""
        if self._state is None:
            return
        img, bias, rig, aux = self._materialize()
        self._ref_img, self._ref_bias, self._aux = img, bias, aux
        # the rig field folds the global rigidity in; unfold it so
        # _build_map can apply it again (mask-equivalent: field / rigidity)
        if rig is not None and self.rigidity > 0:
            self._ref_rig = rig / torch.tensor(np.float32(self.rigidity))
        else:
            self._ref_rig = rig
        self._ref_w, self._ref_h = self._w, self._h
        self._state = None
        self._cfg = None

    # -- output -------------------------------------------------------------

    def get_image(self) -> np.ndarray:
        """Current materialized image, [h, w, C] uint8, image orientation."""
        with annotate("carver.get_image"):
            img = self.get_image_device()
            with annotate("carver.copy_out"):
                img = img.cpu()
            count("bytes.d2h", img.nbytes)
            with annotate("carver.host_copy"):
                return img.numpy().copy()   # never a view

    def get_image_device(self) -> torch.Tensor:
        """Current materialized image as a tensor on the carver's device
        ([h, w, C] u8, image orientation), for pipelines that feed it
        onward without a copy to the host. Always a fresh tensor: writing
        to it leaves the carver as it was."""
        img = self._materialize()[0]
        return img.clone() if self._state is None else img

    def get_aux(self, i: int) -> np.ndarray:
        """Current materialized aux image i (the identical seam sequence),
        [h, w, C_i] uint8, a host copy."""
        aux = self._materialize()[3][i].cpu()
        count("bytes.d2h", aux.nbytes)
        return aux.numpy().copy()

    def vmap_dump(self) -> VMap | None:
        """lqr_vmap_dump: snapshot the current visibility map."""
        return self._record_vmap()

    @property
    def vmaps(self) -> list[VMap]:
        """lqr_vmap_list: all recorded maps."""
        return list(self._vmaps)

    # -- introspection (lqr_carver_get_*) -----------------------------------

    @property
    def width(self) -> int:
        return self._w

    @property
    def height(self) -> int:
        return self._h

    @property
    def channels(self) -> int:
        return self._C

    @property
    def ref_width(self) -> int:
        return self._ref_w

    @property
    def ref_height(self) -> int:
        return self._ref_h

    @property
    def orientation(self) -> int:
        return self._orientation

    @property
    def depth(self) -> int:
        return 0 if self._state is None else self._state.depth

    @property
    def scan_by_row(self) -> bool:
        """lqr_carver_scan_by_row: False when the map is transposed."""
        return self._orientation == 0
