"""capture_s.train: the host seconds the program took to capture the training step's CUDA graph (two warm-up
steps on a copy of the state, the capture and the instantiation, closed by a synchronisation), from its
counters ``train_step.capture_s`` and ``train_step.captures``.  ``None`` unless the run captured the step
exactly once."""


def read(run):
    try:
        from mrisr_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    return c["train_step.capture_s"] if c.get("train_step.captures") == 1 else None
