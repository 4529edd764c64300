"""carve_roofline.single: the carve's least time on the card over the device
time inside the traced resize spans, in percent."""

from benchmark import readers


def read(run):
    return readers.carve_roofline_pct(run)
