"""resize_ms: the median a request of the ms in Carver.resize."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, ("resize",))
