"""carver_host_ms: the median a request of the ms in the upload (Carver(...) with its
bias_add calls) and the readback (get_image: materialize and the copy to
the host)."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, ("upload", "readback"))
