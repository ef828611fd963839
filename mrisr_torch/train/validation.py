"""In-training validation: a sampler run, MRI metrics and image strips (port of ``mrisr_tpu/train/validation.py``).

The CLI's training loops call :meth:`ValidationHook.maybe_run` every step
with the current (EMA) parameters; every ``every`` steps it samples a fixed
validation batch, computes PSNR / SSIM / NMSE / HFEN with
``eval/metrics.py`` on [0, 1]-mapped images, writes an ``lr | sr | hr`` PNG
strip per image, and returns the metrics for the logger.  The PNG writer is
the port's own (``data/png.py``), so no PIL is needed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from mrisr_torch.data.png import write_png_gray
from mrisr_torch.eval.metrics import compute_mri_metrics


def strip_pixels(*images: np.ndarray) -> np.ndarray:
    """Images side by side as one uint8 ``[H, sum W]`` array, each min-max scaled to [0, 255] (truncated)."""
    panels = []
    for img in images:
        arr = np.asarray(img, np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        lo, hi = float(arr.min()), float(arr.max())
        arr = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
        panels.append((arr * 255).astype(np.uint8))
    return np.hstack(panels)


def save_image_strip(path: str | Path, *images: np.ndarray) -> None:
    """Save images ([H, W] or [H, W, 1], any range) side by side as one PNG."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png_gray(path, strip_pixels(*images))


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class ValidationHook:
    """Periodic sampler-based validation.

    ``sample_fn(params, lr, generator) -> sr`` runs the reverse chain on the
    fixed NHWC ``val_batch`` ``{lr, hr}`` (numpy); metrics are computed on
    [0, 1]-mapped images (data range 1.0): clipped when
    ``data_in_unit_range``, else mapped from [-1, 1].
    """

    def __init__(
        self,
        sample_fn: Callable,
        val_batch: dict,
        out_dir: str | Path,
        every: int = 5000,
        max_strips: int = 4,
        data_in_unit_range: bool = False,
    ):
        self.sample_fn = sample_fn
        self.val_batch = val_batch
        self.out_dir = Path(out_dir)
        self.every = max(1, every)
        self.max_strips = max_strips
        self.data_in_unit_range = data_in_unit_range

    def _to_unit(self, x: np.ndarray) -> np.ndarray:
        if self.data_in_unit_range:
            return np.clip(x, 0.0, 1.0)
        return np.clip(x / 2.0 + 0.5, 0.0, 1.0)

    def run(self, params, generator: torch.Generator | None) -> dict:
        lr, hr = self.val_batch["lr"], self.val_batch["hr"]
        sr = _numpy(self.sample_fn(params, lr, generator))
        sr_u, hr_u = self._to_unit(sr), self._to_unit(_numpy(hr))
        p, s, n, h = compute_mri_metrics(torch.from_numpy(sr_u.transpose(0, 3, 1, 2).copy()),
                                         torch.from_numpy(hr_u.transpose(0, 3, 1, 2).copy()))
        metrics = {"val_psnr": float(p), "val_ssim": float(s), "val_nmse": float(n), "val_hfen": float(h)}
        lr_u = self._to_unit(_numpy(lr))
        for b in range(min(self.max_strips, sr.shape[0])):
            save_image_strip(self.out_dir / f"val_{b:02d}.png", lr_u[b], sr_u[b], hr_u[b])
        return metrics

    def maybe_run(self, step: int, params, generator: torch.Generator | None) -> dict | None:
        if step > 0 and step % self.every == 0:
            return self.run(params, generator)
        return None
