"""A closed loop of one client: the next request the moment the last one returns.

So a caller that waits for each reply sends its requests (``sr-volume`` serving
a volume's batches one after the other).  Each request's wall time runs from
its submission to its synchronised output.  The window runs whole requests
until ``seconds`` are spent, so a long request does not cut the rate short.
"""
from __future__ import annotations

import time

from perfbench.stats import Request


def run(system, sync, seconds: float | None = None, count: int | None = None, first: int = 0):
    """Requests ``first``, ``first + 1``, ... one at a time until ``seconds`` have passed (the last one
    finished whole) or ``count`` are done: ``(records, [(request, output)])``."""
    records, outputs = [], []
    begin = time.perf_counter()
    i = first
    while True:
        req = system.request(i)
        t0 = time.perf_counter()
        out = system.serve(req)
        sync()
        t1 = time.perf_counter()
        records.append(Request(t0, t1, system.items(req)))
        outputs.append((req, out))
        i += 1
        if (count is not None and i - first >= count) or (count is None and t1 - begin >= seconds):
            return records, outputs
