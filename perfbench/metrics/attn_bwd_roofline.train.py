"""attn_bwd_roofline.train: the flash-attention backward kernels' (dQ, dK/dV) share of their roofline in the
traced training steps.

The least time of the two kernels at every attention site the configuration sends to the flash kernels (its
queries, keys, width and precision, from the reference), over the device time of the trace's records whose name
holds ``PATTERN``, in percent.  Where the trace lacks some records, their time is taken as the mean of those it
holds.
"""
from perfbench import peaks

PATTERN = "flash_bwd_"
KERNELS = 2  # dQ and dK/dV a site


def expected_launches(work):
    return PATTERN, KERNELS * sum(s["count"] for s in work["attention"])


def read(run):
    sites = run.work["attention"]
    launches = KERNELS * sum(s["count"] for s in sites) * run.traced_requests
    if run.trace is None or not launches:
        return None
    seen, seconds = run.trace.kernels(PATTERN)
    if not seen:
        return None
    least = run.traced_requests * sum(
        peaks.flash_bwd_seconds(s["b"], s["n"], s["m"], s["d"], s["precision"]) * s["count"] for s in sites)
    return 100.0 * least / seconds * min(1.0, seen / launches)
