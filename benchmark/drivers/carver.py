"""One image through ``lqr_tpu_torch.Carver``, as a plugin or library
caller sends it: the upload (``Carver(...)`` with its ``bias_add`` and
``rigmask_add`` calls), ``resize`` to the narrower width, and
``get_image`` back to host memory.

Traffic keys: ``height``, ``width``, ``seams``, ``pool`` (distinct images,
taken in turn), ``masks`` (each {"shape", "area", "coefficient"}: a
[height, width] bias mask a request, its factor the configuration's
coefficient of that name), ``rigmasks`` (each {"shape", "area"}: a
[height, width] rigidity mask a request, placed after the bias masks and
scaled by the configuration's rigidity), ``check_requests``,
``trace_requests``. Masks are placed at the origin, the size of the image,
as the plugin places its mask layers.
"""

from __future__ import annotations

import numpy as np

from .. import inputs, work
from ..reference.compare import Answer


class Client:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import lqr_tpu_torch
        self._carver = lqr_tpu_torch.Carver
        self.config, self.device = config, device
        h, w = int(traffic["height"]), int(traffic["width"])
        self.h, self.w, self.seams = h, w, int(traffic["seams"])
        n = int(traffic["pool"])
        self.images = inputs.image_pool(n, h, w, seed, device)
        spec = traffic.get("masks", [])
        self.masks = [
            [(m, float(config[s["coefficient"]])) for m, s in zip(ms, spec)]
            for ms in inputs.masks(spec, n, h, w, seed)]
        rigspec = traffic.get("rigmasks", [])
        self.rigmasks = inputs.masks(rigspec, n, h, w, seed, stream=5)
        # the carver carries a rigidity plane under a global rigidity or a
        # rigidity mask
        self.ops, self.nbytes = work.carve_work(
            h, w, 3, self.seams, nrg=config["energy"],
            delta_x=config["delta_x"], has_bias=bool(spec),
            has_rig=config["rigidity"] > 0 or bool(rigspec))

    def request(self, i: int, span):
        """Request i (the warm-up is -1): returns (seams, operations,
        bytes, what the check keeps)."""
        k = i % len(self.images)
        cfg = self.config
        with span("upload", i):
            c = self._carver(self.images[k], delta_x=cfg["delta_x"],
                             rigidity=cfg["rigidity"], device=self.device)
            c.set_energy_function(cfg["energy"])
            c.set_side_switch_frequency(cfg["side_switch_frequency"])
            for mask, factor in self.masks[k]:
                c.bias_add(mask, factor)
            for mask in self.rigmasks[k]:
                c.rigmask_add(mask)
        with span("resize", i):
            c.resize(self.w - self.seams, self.h)
        with span("readback", i):
            out = c.get_image()
        return self.seams, self.ops, self.nbytes, (k, c, out)

    def freeze(self, i: int, keep) -> list[Answer]:
        """The kept request's answer on the host; its carver is let go."""
        k, c, out = keep
        vm = c.vmap_dump()     # None: no seam was carved
        vs = (np.zeros((self.h, self.w), np.int32) if vm is None
              else np.asarray(vm.data, np.int32))
        return [Answer(self.images[k], self.masks[k], self.seams, vs, out,
                       self.rigmasks[k])]
