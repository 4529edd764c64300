"""device_idle_pct.single: the share of the traced window in which the card ran
no kernel and no copy, in percent."""

from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)
