"""carve_roofline.batch: the carve's least time on the card over the device
time inside the traced carve spans, in percent."""

from benchmark import readers


def read(run):
    return readers.carve_roofline_pct(run)
