"""materialize_ms.batch: the median a wave of the device ms of the events
launched inside the program's ``batch.materialize`` span
(``materialize_batched`` in ``BatchCarver.images_at``)."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms(run, "batch.materialize")
