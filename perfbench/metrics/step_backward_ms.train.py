"""step_backward_ms.train: the device milliseconds of the training step's backward pass, read inside the
program: the ``train.backward`` stage of the graphed step's last replay (the traced stretch's last step), timed
by the event pair the program records in its graph (``mrisr_torch.utils.profiling.stage_ms("train_step")``).
``None`` where the program records no such stage."""


def read(run):
    try:
        from mrisr_torch.utils.profiling import stage_ms
    except ImportError:
        return None
    return stage_ms("train_step").get("train.backward")
