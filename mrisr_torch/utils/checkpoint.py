"""Checkpoints of the train state by step, with retention (port of ``mrisr_tpu/utils/checkpoint.py``).

The reference's interface over ``torch.save`` / ``torch.load(weights_only=True)``:
one file ``step_<n>.pt`` per saved step, holding ``TrainState.state_dict()``
(parameters, optimizer state, EMA and step).
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from mrisr_torch.train.state import TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Write ``state`` as step ``step``; an existing step is rewritten only with ``force``."""
        path = self._path(step)
        if path.exists() and not force:
            return False
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.all_steps()[: -self.max_to_keep]:
                self._path(old).unlink()
        return True

    def restore(self, state_template: TrainState, step: int | None = None) -> TrainState:
        """The saved state (the latest when ``step`` is None), on the template's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return state_template.load_state_dict(tree)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := _NAME.fullmatch(p.name)))

    def close(self) -> None:
        """Nothing is held open; kept for the reference's interface."""
