"""setup_s: process start to the first timed request, compile included."""


def read(run):
    return run.setup_s
