"""Faults planted in the program's timed path, to show that the check calls such a run not correct.

Each fault is a context manager that swaps one function of the port for a broken one and puts it back on exit.
The CPU tests (``tests/test_perfbench_faults.py``) drive whole runs with each; ``readings.py --fault`` reads one
on the card at a cell's own size.

- ``step_unchanged``: a DDIM step returns its state unchanged (serving);
- ``state_unchanged``: a training step leaves the parameters and the optimizer's state as they were;
- ``ema_unchanged``: a training step updates the parameters and leaves their EMA as it was;
- ``half_batch_serve``: a served batch's second half left out, answered with the first half's answers;
- ``half_batch_train``: a training step's loss the mean over the first half of its rows, the rest left out;
- ``answer_altered``: one served slice's answer moved by 0.1 (of the [-1, 1] range) where it is produced.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def swapped(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def step_unchanged():
    from mrisr_torch.pipelines import sampler

    return swapped(sampler, "ddim_step", lambda original: lambda sched, x_t, *a, **k: x_t)


def half_batch_serve():
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    def broken(original):
        def half(self, lr, generator=None, x_T=None, num_steps=50, spacing="trailing"):
            h = lr.shape[0] // 2
            out = original(self, lr[:h], generator, None if x_T is None else x_T[:h], num_steps, spacing)
            return torch.cat([out, out], dim=0)

        return half

    return swapped(ResDiffPipeline, "super_resolve", broken)


def half_batch_train():
    from mrisr_torch.train import steps

    def broken(original):
        return lambda pred, target: original(pred[: pred.shape[0] // 2], target[: target.shape[0] // 2])

    return swapped(steps, "l2", broken)


def answer_altered():
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    def broken(original):
        def altered(self, *a, **k):
            out = original(self, *a, **k)
            out[0] += 0.1
            return out

        return altered

    return swapped(ResDiffPipeline, "super_resolve", broken)


def state_unchanged():
    from mrisr_torch.train.state import TrainState

    return swapped(TrainState, "update_tensors_", lambda original: lambda self, grads: None)


def ema_unchanged():
    from mrisr_torch.train.state import TrainState

    return swapped(TrainState, "_ema_", lambda original: lambda self: None)


FAULTS = {"step_unchanged": step_unchanged, "state_unchanged": state_unchanged, "ema_unchanged": ema_unchanged,
          "half_batch_serve": half_batch_serve, "half_batch_train": half_batch_train,
          "answer_altered": answer_altered}
