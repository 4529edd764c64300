"""kernels_per_seam: device kernels inside the traced resize spans, PyTorch's
included, over the seams carved."""

from benchmark import readers


def read(run):
    return readers.kernels_per_seam(run)
