"""seams_per_s: the seams removed by every request of the window (a wave
counts images x seams) over the window's seconds."""


def read(run):
    if not run.requests:
        return None
    return sum(r.seams for r in run.requests) / run.window_s
