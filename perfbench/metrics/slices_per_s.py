"""slices_per_s: slices of every request completed in the window over the window's span, first submission to
last synchronised output."""
from perfbench import stats


def read(run):
    return stats.items_per_s(run.records)
