"""train_samples_per_s: samples of every training step in the window over the window's span, loader waits
included, from the first step's wait for its batch to the synchronisation after the last."""
from perfbench import stats


def read(run):
    return stats.items_per_s(run.records)
