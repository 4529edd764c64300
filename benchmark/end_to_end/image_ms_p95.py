"""image_ms_p95: the 95th percentile, over every request of the window,
of the time from handing the host image to the carver to the resized
image in host memory."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([(r.end - r.start) * 1e3
                                for r in run.requests], 95))
