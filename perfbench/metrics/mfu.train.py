"""mfu.train: the training steps' share of the card's peak over the window: the least time of every step's
operations (forward and backward, counted on the reference at the cell's shapes, each at the peak of the
precision the configuration states for it), over the window's span, in percent."""
from perfbench import flops, stats


def read(run):
    least = flops.seconds_at_peak(run.work["flops"])
    done = sum(r.ok for r in run.records)
    return 100.0 * least * done / stats.span_s(run.records)
