"""Waves of images through ``lqr_tpu_torch.parallel.BatchCarver``, as a
photo batch or an animation sends them: the copy to the card
(``BatchCarver(wave)``), ``carve``, and ``images_at`` back to host memory.

Traffic keys: ``size`` (square images), ``batch`` (images a wave),
``seams``, ``pool`` (distinct waves, taken in turn), ``check_requests``
(waves kept for the check), ``check_images`` (images checked of each),
``trace_requests``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs, work
from ..reference.compare import Answer


class Client:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lqr_tpu_torch.parallel import BatchCarver
        self._batch = BatchCarver
        self.config, self.device, self.seed = config, device, seed
        self.size, self.seams = int(traffic["size"]), int(traffic["seams"])
        self.batch = int(traffic["batch"])
        self.n_check = int(traffic["check_images"])
        self.waves = inputs.waves(int(traffic["pool"]), self.batch,
                                  self.size, seed, device)
        ops, nbytes = work.carve_work(
            self.size, self.size, 3, self.seams, nrg=config["energy"],
            delta_x=config["delta_x"], has_bias=False,
            has_rig=config["rigidity"] > 0)
        self.ops, self.nbytes = self.batch * ops, self.batch * nbytes

    def request(self, i: int, span):
        """Wave i (the warm-up is -1): returns (seams, operations, bytes,
        what the check keeps)."""
        k = i % len(self.waves)
        cfg = self.config
        with span("upload", i):
            bc = self._batch(self.waves[k], delta_x=cfg["delta_x"],
                             nrg=cfg["energy"], rigidity=cfg["rigidity"],
                             device=self.device)
            if (i < 0 and bc.cfg.side_switch_freq
                    != cfg["side_switch_frequency"]):
                raise ValueError("BatchCarver's side-switch frequency is "
                                 f"{bc.cfg.side_switch_freq}, the "
                                 "configuration's "
                                 f"{cfg['side_switch_frequency']}")
        with span("carve", i):
            bc.carve(self.seams)
        with span("readback", i):
            out = bc.images_at(self.size - self.seams)
        return self.batch * self.seams, self.ops, self.nbytes, (k, bc, out)

    def freeze(self, i: int, keep) -> list[Answer]:
        """check_images images of the kept wave, drawn from the seed, on
        the host; the wave's carver is let go."""
        k, bc, out = keep
        r = np.random.default_rng([inputs.seed64(self.seed, 4), i])
        pick = np.sort(r.choice(self.batch, self.n_check, replace=False))
        vs = bc.state.vs[torch.as_tensor(pick, device=bc.state.vs.device)]
        vs = vs[:, :, :self.size].cpu().numpy()
        return [Answer(self.waves[k][j], [], self.seams, vs[n],
                       np.asarray(out[j])) for n, j in enumerate(pick)]

