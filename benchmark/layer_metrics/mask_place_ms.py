"""mask_place_ms: the median a request of the host ms in the program's
``carver.place_mask`` spans (the placement of each bias mask, by
``Carver.bias_add``, and each rigidity mask, by ``Carver.rigmask_add``, on
the host by ``codec.place_mask``, span ``mask.host``, and its copy to the
card, ``mask.copy``)."""

from benchmark import program_spans


def read(run):
    return program_spans.host_ms(run, "carver.place_mask")
