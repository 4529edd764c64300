"""upload_mb.batch: the median a wave of the program's ``bytes.h2d``
counter (``BatchCarver(...)``'s padded host buffer and planes copied to
the card), in MB (10^6 bytes)."""

from benchmark import program_spans


def read(run):
    return program_spans.counted(run, "bytes.h2d", 1e-6)
