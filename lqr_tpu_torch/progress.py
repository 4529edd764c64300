"""Progress reporting — the LqrProgress protocol
(gimp-lqr-plugin src/render.c:767-779; SURVEY.md §5 "Progress reporting").

A progress object has ``init(message)``, ``update(fraction)``, ``end()``,
driven from inside the engine's hot loop (chunked so device sync cost stays
bounded). ``ConsoleProgress`` renders a simple console bar, mirroring
``gimp_progress_*`` behavior; custom frontends implement the same trio.

A copy of ``lqr_tpu.progress``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sys
import time

from .i18n import _


class Progress:
    """Base protocol (no-op). init/update/end like LqrProgress."""

    init_width_message = "Resizing width..."
    init_height_message = "Resizing height..."

    def init(self, message: str):
        pass

    def update(self, fraction: float):
        pass

    def end(self):
        pass


class ConsoleProgress(Progress):
    def __init__(self, stream=None, width: int = 40):
        self.stream = stream or sys.stderr
        self.width = width
        self._msg = ""
        self._t0 = 0.0

    def init(self, message: str):
        self._msg = message
        self._t0 = time.time()
        self.update(0.0)

    def update(self, fraction: float):
        n = int(self.width * max(0.0, min(1.0, fraction)))
        bar = "#" * n + "-" * (self.width - n)
        self.stream.write(f"\r{self._msg} [{bar}] {fraction * 100:5.1f}%")
        self.stream.flush()

    def end(self):
        dt = time.time() - self._t0
        done = _("done in {seconds:.2f}s").format(seconds=dt)
        self.stream.write(f"\r{self._msg} {done}" + " " * self.width + "\n")
        self.stream.flush()


class CollectingProgress(Progress):
    """Records every callback (for tests)."""

    def __init__(self):
        self.events = []

    def init(self, message: str):
        self.events.append(("init", message))

    def update(self, fraction: float):
        self.events.append(("update", fraction))

    def end(self):
        self.events.append(("end",))
