"""seam_issue_us: the host µs a seam inside ``core.engine.extend_map``
in the untraced requests of the window (those after the traced ones):
the program's always-on counters ``route_ns.<route>`` over
``seams.<route>``, summed over the routes taken. The time to issue a
seam's launches, plus any wait of the route (a full launch queue),
without the profiler's own cost a traced request carries."""

from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    ns = sum(program_spans.after_trace("route_ns.").values())
    seams = sum(program_spans.after_trace("seams.").values())
    return ns / seams / 1e3 if seams else None
