"""The arithmetic of a window of requests: rates and percentiles."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Request:
    start: float  # host clock at submission, seconds
    end: float  # host clock once its output is synchronised
    items: int  # slices (or samples) it carried
    ok: bool = True
    wait: float = 0.0  # seconds the loop waited for its input (a training step's batch)


def span_s(records: list[Request]) -> float:
    """From the first request's start to the last one's end."""
    return max(r.end for r in records) - min(r.start for r in records)


def items_per_s(records: list[Request]) -> float:
    """Items of every request completed in the window over the window's span: each request counts whole."""
    return sum(r.items for r in records if r.ok) / span_s(records)


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile, linear between the two nearest ranks (numpy's default, Python's
    ``inclusive`` method)."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def latency_percentile_ms(records: list[Request], q: float) -> float:
    """The ``q``-th percentile of every request's wall time, submission to synchronised output; a request
    that failed counts at the longest time seen."""
    worst = max(r.end - r.start for r in records)
    return percentile([(r.end - r.start) if r.ok else worst for r in records], q) * 1e3
