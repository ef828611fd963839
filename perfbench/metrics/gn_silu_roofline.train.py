"""gn_silu_roofline.train: the GroupNorm+SiLU kernel's share of its roofline in the traced training steps (its
forward launches; the backward is a composition of library kernels).

The least time of every GroupNorm followed by SiLU in the configuration (its shape and precision, from the
reference; x read once, y written once), over the device time of the trace's records whose name holds
``PATTERN``, in percent.  Where the trace lacks some records, their time is taken as the mean of those it holds.
"""
from perfbench import peaks

PATTERN = "gn_silu_kernel"


def launches(heads):
    """Launches a request: a head's ``count``, or its ``launches`` where the program fuses heads."""
    return sum(h.get("launches", h["count"]) for h in heads)


def expected_launches(work):
    return PATTERN, launches(work["gn_silu"])


def read(run):
    heads = run.work["gn_silu"]
    expected = launches(heads) * run.traced_requests
    if run.trace is None or not expected:
        return None
    seen, seconds = run.trace.kernels(PATTERN)
    if not seen:
        return None
    least = run.traced_requests * sum(
        peaks.gn_silu_seconds(tuple(h["shape"]), h["precision"], h["param_precision"]) * h["count"] for h in heads)
    return 100.0 * least / seconds * min(1.0, seen / expected)
