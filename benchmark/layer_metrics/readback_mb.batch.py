"""readback_mb.batch: the median a wave of the program's ``bytes.d2h``
counter (``BatchCarver.images_at``'s copy to host memory), in MB (10^6
bytes)."""

from benchmark import program_spans


def read(run):
    return program_spans.counted(run, "bytes.d2h", 1e-6)
