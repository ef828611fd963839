"""attn_fwd_roofline.serve: the flash-attention forward kernel's share of its roofline in the traced requests.

The least time of every attention site that the configuration sends to the kernel (its queries, keys, width
and precision, from the reference), over the device time of the trace's records whose name holds ``PATTERN``,
in percent.  Where the trace lacks some records, their time is taken as the mean of those it holds.
"""
from perfbench import peaks

PATTERN = "flash_fwd_"


def expected_launches(work):
    return PATTERN, sum(s["count"] for s in work["attention"])


def read(run):
    sites = run.work["attention"]
    launches = sum(s["count"] for s in sites) * run.traced_requests
    if run.trace is None or not launches:
        return None
    seen, seconds = run.trace.kernels(PATTERN)
    if not seen:
        return None
    least = run.traced_requests * sum(
        peaks.flash_fwd_seconds(s["b"], s["n"], s["m"], s["d"], s["precision"]) * s["count"] for s in sites)
    return 100.0 * least / seconds * min(1.0, seen / launches)
