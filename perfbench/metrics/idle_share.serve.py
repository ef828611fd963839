"""idle_share.serve: the share of the traced stretch of serving requests in which no operation ran on the
device, in percent."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
