"""materialize_ms.single: the median a request of the device ms of the
events launched inside the program's ``carver.materialize`` span
(``engine.materialize_all``: the image, and a mask's bias plane)."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms(run, "carver.materialize")
