"""batch_p90_ms: the 90th percentile of every request's wall time in the window, submission to synchronised
output."""
from perfbench import stats


def read(run):
    return stats.latency_percentile_ms(run.records, 90.0)
