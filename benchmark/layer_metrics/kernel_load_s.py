"""kernel_load_s: the seconds the process spent loading the program's
compiled libraries, their builds included: ``setup.kernels_s`` (the CUDA
kernels, ``ops._build.load``) plus ``setup.native_s`` (the g++ libraries
of the codec and the reference carver). Read in traced runs; None where
the program counts neither."""

from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    c = program_spans.counters()
    parts = [c[k] for k in ("setup.kernels_s", "setup.native_s") if k in c]
    return float(sum(parts)) if parts else None
