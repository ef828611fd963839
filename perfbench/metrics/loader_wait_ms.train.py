"""loader_wait_ms.train: the mean milliseconds a training step waited for the loader's next batch (the harness's
own span around it)."""


def read(run):
    return 1e3 * sum(r.wait for r in run.records) / len(run.records)
