"""replay_idle_ms.serve: the milliseconds a chain's graph launch leaves the device idle.

For each ``resdiff.replay`` span in the trace (the program's host range around ``graph.replay()``), its length
less the device's busy time inside it; the mean over the traced requests.  The harness's own work between
requests (selecting a request's inputs, the synchronisation) lies outside these spans.  ``None`` where the
trace holds no such span.
"""

SPAN = "resdiff.replay"


def read(run):
    if run.trace is None:
        return None
    spans = [(start, end) for name, start, end in run.trace.host if name == SPAN]
    if not spans:
        return None
    busy = run.trace.busy_intervals()
    idle_ns = [(end - start) - sum(max(0, min(end, b) - max(start, a)) for a, b in busy) for start, end in spans]
    return sum(idle_ns) / len(idle_ns) / 1e6
