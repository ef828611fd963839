"""capture_s.serve: the host seconds the program took to capture the served chain's CUDA graph (its eager
warm-up chain, the capture and the instantiation, closed by a synchronisation), from its counters
``resdiff.capture_s`` and ``resdiff.captures``.  ``None`` unless the run captured the chain exactly once."""


def read(run):
    try:
        from mrisr_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    return c["resdiff.capture_s"] if c.get("resdiff.captures") == 1 else None
