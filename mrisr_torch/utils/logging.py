"""Metric logging: console and a JSONL file, optionally W&B (port of ``mrisr_tpu/utils/logging.py``).

Each :meth:`MetricLogger.log` call prints one line and appends one record
``{metric: value, ..., "step": n, "ts": unix_time}`` to ``metrics.jsonl``
under ``out_dir``, as the reference does.  A tensor metric is read with
``float()`` (one host sync).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricLogger:
    def __init__(self, out_dir: str | Path | None = None, use_wandb: bool = False, project: str = "mrisr_torch",
                 config: dict | None = None):
        self.out_path = None
        if out_dir is not None:
            p = Path(out_dir)
            p.mkdir(parents=True, exist_ok=True)
            self.out_path = p / "metrics.jsonl"
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=config or {})
            except Exception as e:  # offline or not installed
                print(f"[logging] wandb unavailable ({e}); using JSONL only")

    def log(self, step: int, metrics: dict[str, Any], prefix: str = ""):
        payload = {f"{prefix}{k}": _to_py(v) for k, v in metrics.items()}
        payload["step"] = step
        payload["ts"] = time.time()
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in payload.items() if k != "ts")
        print(f"[{step:>8d}] {line}")
        if self.out_path is not None:
            with open(self.out_path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
