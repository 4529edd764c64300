"""wave_host_ms: the median a wave of the ms in the upload (BatchCarver(...),
the copy to the card) and the readback (images_at: materialize and the
copy to the host)."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, ("upload", "readback"))
