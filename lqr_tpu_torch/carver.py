"""The ``Carver`` host API on PyTorch: liblqr's carver surface.

Counterpart of ``lqr_tpu.carver`` for the carving path: construction
(``delta_x``, ``rigidity``), the setters, ``resize`` with orientation by
transpose and multi-pass enlargement, ``flatten``, ``get_image``, the
visibility-map dump and the introspection properties. Masks
(``bias_add``/``rigmask_add``) and attached aux images are not ported yet.

The device is explicit: ``device="cuda"`` (the default) runs the DP and
backtrack as CUDA kernels and raises when CUDA is absent; ``device="cpu"``
runs their plain versions. Pixel data stays on the device; only
``get_image`` and ``vmap_dump`` copy to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (EnergyFunc, ResizeOrder, DEFAULT_SIDE_SWITCH_FREQUENCY,
                     MAX_DELTA_X, MAX_ENL_STEP, MIN_ENL_STEP)
from .errors import LqrConfigError, LqrStateError, check_channels
from .core.state import EngineConfig, init_state, round_up
from .core import engine as eng
from .i18n import _


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


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LqrConfigError(
            _("device {d} requested but CUDA is not available; pass "
              "device=\"cpu\" for the CPU path").format(d=device))
    if dev.type not in ("cuda", "cpu"):
        raise LqrConfigError(
            _("unsupported device {d}; use \"cuda\" or \"cpu\"")
            .format(d=device))
    return dev


class Carver:
    """A carver over an [H, W, C] uint8 image (C in 1..4)."""

    def __init__(self, pixels: np.ndarray, delta_x: int = 1,
                 rigidity: float = 0.0, device="cuda"):
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
        self.device = _resolve_device(device)
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
        self._ref_img = torch.tensor(pixels, device=self.device)   # a copy
        self._ref_rig = None                # f32 [h, w] or None
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

    # -- map plumbing -------------------------------------------------------

    def _drop_map(self):
        """Invalidate an uncarved map so config changes take effect."""
        if self._state is not None and self._state.depth:
            raise LqrStateError(
                _("internal: dropping a map with carved seams — this is "
                  "a bug; callers must flatten first"))
        self._state = None
        self._cfg = None

    def _local_dims(self, orientation):
        if orientation == 0:
            return self._ref_h, self._ref_w
        return self._ref_w, self._ref_h

    def _build_map(self, orientation: int):
        """Create a fresh MapState in the given orientation."""
        H, W = self._local_dims(orientation)
        img, rig = self._ref_img, self._ref_rig
        if orientation == 1:
            img = img.transpose(0, 1)
            rig = None if rig is None else rig.transpose(0, 1)
        cfg = EngineConfig(
            H=H, Wb=_bucket(W), C=self._C, delta_x=self.delta_x,
            nrg=int(self.nrg), side_switch_freq=self.side_switch_freq,
            has_rig=rig is not None or self.rigidity > 0,
        )
        rig_field = None
        if cfg.has_rig:
            # per-pixel rigidity = global rigidity x mask strength, or the
            # global rigidity alone (SPEC.md §4)
            rigidity = torch.tensor(np.float32(self.rigidity))
            if rig is not None:
                rig_field = rig * rigidity
            else:
                rig_field = torch.full((H, W), np.float32(self.rigidity),
                                       dtype=torch.float32,
                                       device=self.device)
        self._state = init_state(cfg, img, rig=rig_field, device=self.device)
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
        for orientation in order:
            target = width if orientation == 0 else height
            before = self._w if orientation == 0 else self._h
            self._resize_axis(orientation, target)
            if self.dump_vmaps and target != before:
                self._record_vmap()

    def _materialize(self):
        """(img, rig) of the live map at the current size, image
        orientation, each cut to the current width."""
        st, cfg = self._state, self._cfg
        w_local = self._w if self._orientation == 0 else self._h
        out_Wb = _bucket(max(w_local, st.ref_w))
        img, _b, rig, _aux = eng.materialize_all(cfg, st, w_local, out_Wb)
        img = img[:, :w_local]
        rig = None if rig is None else rig[:, :w_local]
        if self._orientation == 1:
            img = img.transpose(0, 1)
            rig = None if rig is None else rig.transpose(0, 1)
        return img.contiguous(), rig

    def flatten(self):
        """lqr_carver_flatten: the current size becomes the new reference."""
        if self._state is None:
            return
        img, rig = self._materialize()
        self._ref_img = img
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
        img = self._ref_img if self._state is None else self._materialize()[0]
        return np.array(img.cpu())      # a copy, never a view of the state

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
