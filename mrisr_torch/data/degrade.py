"""Synthetic low-field degradation, the FastMRI path (port of ``mrisr_tpu/data/degrade.py``).

Gaussian blur with sigma = 0.5 * scale (scipy's 'reflect' boundary), a
PIL-BICUBIC downsample by ``scale`` and a BICUBIC upsample back.

* :func:`simulate_low_res`: tensors, on any device (whole batches at once);
* :func:`simulate_low_res_np`: numpy for the data path on the host, with
  ``scipy.ndimage.gaussian_filter`` and the port's own PIL-equivalent
  bicubic (``ops/resize.py``), so it needs no PIL.
"""
from __future__ import annotations

import numpy as np
import torch

from mrisr_torch.ops.resize import gaussian_blur, pil_resize_like, pil_resize_like_np


def simulate_low_res(hr: torch.Tensor, scale: float = 4.0) -> torch.Tensor:
    """``hr``: ``[..., H, W]`` in any range; returns a degraded copy of the same shape."""
    h, w = hr.shape[-2], hr.shape[-1]
    blurred = gaussian_blur(hr, 0.5 * scale)
    lr = pil_resize_like(blurred, (int(h // scale), int(w // scale)), filt="bicubic")
    return pil_resize_like(lr, (h, w), filt="bicubic")


def simulate_low_res_np(hr: np.ndarray, scale: float = 4.0) -> np.ndarray:
    """``hr``: ``[H, W]``; float32 out, the reference's PIL path without PIL."""
    from scipy.ndimage import gaussian_filter

    blurred = gaussian_filter(hr.astype(np.float32), sigma=0.5 * scale)
    h, w = hr.shape
    lr = pil_resize_like_np(blurred, (int(h // scale), int(w // scale)), filt="bicubic")
    return pil_resize_like_np(lr, (h, w), filt="bicubic")
