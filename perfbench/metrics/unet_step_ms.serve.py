"""unet_step_ms.serve: the device milliseconds of one UNet step of the served chain, read inside the program.

The ``resdiff.steps`` stage of the captured chain's last replay (the traced stretch's last request), timed by
the event pair the program records in its graph (``mrisr_torch.utils.profiling.stage_ms("resdiff.chain")``),
over the configuration's ``num_steps``.  ``None`` where the program records no such stage.
"""


def read(run):
    try:
        from mrisr_torch.utils.profiling import stage_ms
    except ImportError:
        return None
    ms = stage_ms("resdiff.chain").get("resdiff.steps")
    return None if ms is None else ms / run.cell.config["num_steps"]
