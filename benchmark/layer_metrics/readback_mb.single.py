"""readback_mb.single: the median a request of the program's ``bytes.d2h``
counter (bytes copied from the carver's tensors to host arrays), in MB
(10^6 bytes)."""

from benchmark import program_spans


def read(run):
    return program_spans.counted(run, "bytes.d2h", 1e-6)
