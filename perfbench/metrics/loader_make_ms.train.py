"""loader_make_ms.train: the mean milliseconds the loader's thread took to make a batch (gather and pin), from
the program's counters ``loader.make_s`` and ``loader.made`` over the whole run.  Against the step's time it
says how close the thread is to setting the pace.  ``None`` where the program counts no batch."""


def read(run):
    try:
        from mrisr_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    return 1e3 * c["loader.make_s"] / c["loader.made"] if c.get("loader.made") else None
