"""A training loop fed by the program's loader, as a training script runs it."""
from __future__ import annotations

import itertools
import time

from perfbench.stats import Request


def run(system, sync, seconds: float | None = None, count: int | None = None, first: int = 0):
    """Wait for the loader's next batch, then hand it to the step, with no wait for the device between steps;
    until ``seconds`` have passed or ``count`` steps are done, then one synchronisation.  One record a step: its
    wait for the batch, and its end on the host (the last step's after the synchronisation), so the window spans
    all the work.  ``(records, [])``."""
    records = []
    begin = time.perf_counter()
    for i in itertools.count(first):
        t0 = time.perf_counter()
        batch = system.next_batch()
        t1 = time.perf_counter()
        system.train_step(batch)
        records.append(Request(t0, time.perf_counter(), system.items(batch), wait=t1 - t0))
        if (count is not None and i + 1 - first >= count) or (count is None and records[-1].end - begin >= seconds):
            break
    sync()
    records[-1].end = time.perf_counter()
    return records, []
