"""upload_mb.single: the median a request of the program's ``bytes.h2d``
counter (the image, each mask's strength field and aux image copied
from host arrays to the carver's tensors), in MB (10^6 bytes)."""

from benchmark import program_spans


def read(run):
    return program_spans.counted(run, "bytes.h2d", 1e-6)
