"""wave_carve_ms: the median a wave of the ms in BatchCarver.carve."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, ("carve",))
