"""MRI reconstruction metrics: PSNR / SSIM / NMSE / HFEN (port of ``mrisr_tpu/eval/metrics.py``).

The tensor-level metrics on ``[B, C, H, W]`` tensors, with the reference's
semantics: torchmetrics PSNR / SSIM with ``data_range=1.0`` (SSIM: 11x11
Gaussian window of sigma 1.5, reflect padding of (k-1)//2, valid filtering,
the padded border cropped from the index map before the mean; k1 0.01, k2
0.03), NMSE as the un-squared norm ratio, HFEN through a fixed 3x3 Laplacian
with zero padding.  ``hfen_log`` is the folder evaluator's Laplacian of
Gaussian HFEN on numpy arrays (scipy).

Every filter is written as a sum of shifted slices in float32, so the metrics
are full fp32 on any device (a cuDNN convolution would run in TF32 by
default on the card).
"""
from __future__ import annotations

import numpy as np
import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole batch (torchmetrics default)."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_valid(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 2-D filter with valid padding over the last two dims of ``x``."""
    n = k1d.shape[0]
    h, w = x.shape[-2] - n + 1, x.shape[-1] - n + 1
    rows = sum(k1d[i] * x[..., i : i + h, :] for i in range(n))
    return sum(k1d[i] * rows[..., :, i : i + w] for i in range(n))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity, torchmetrics-compatible.  Inputs ``[B, C, H, W]``."""
    pad = (kernel_size - 1) // 2
    p = torch.nn.functional.pad(pred.float(), (pad, pad, pad, pad), mode="reflect")
    t = torch.nn.functional.pad(target.float(), (pad, pad, pad, pad), mode="reflect")

    k = _gaussian_kernel1d(kernel_size, sigma, p.device)
    mu_p = _filter2d_valid(p, k)
    mu_t = _filter2d_valid(t, k)
    # Variances and covariance of globally mean-shifted tensors, as the
    # reference: E[x^2] - E[x]^2 cancels in fp32 on near-flat images, and a
    # scalar shift leaves these terms unchanged in exact arithmetic.
    sp, st = torch.mean(p), torch.mean(t)
    p0, t0 = p - sp, t - st
    mu_p0, mu_t0 = mu_p - sp, mu_t - st
    sigma_p = _filter2d_valid(p0 * p0, k) - mu_p0**2
    sigma_t = _filter2d_valid(t0 * t0, k) - mu_t0**2
    sigma_pt = _filter2d_valid(p0 * t0, k) - mu_p0 * mu_t0

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    upper = (2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)
    lower = (mu_p**2 + mu_t**2 + c1) * (sigma_p + sigma_t + c2)
    ssim_map = upper / lower
    interior = ssim_map[..., pad:-pad, pad:-pad] if pad > 0 else ssim_map
    return torch.mean(interior)


def nmse(pred: torch.Tensor, target: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """Normalised MSE: ``norm(target - pred) / norm(target)``; ``squared=True`` gives the
    ratio of squared norms (the folder evaluator's form)."""
    num = torch.linalg.norm((target - pred).ravel())
    den = torch.linalg.norm(target.ravel())
    if squared:
        return num**2 / (den**2 + 1e-8)
    return num / den


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 Laplacian [[0, 1, 0], [1, -4, 1], [0, 1, 0]] with zero 'same' padding."""
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    h, w = x.shape[-2], x.shape[-1]
    return (xp[..., 0:h, 1 : w + 1] + xp[..., 2 : h + 2, 1 : w + 1] + xp[..., 1 : h + 1, 0:w]
            + xp[..., 1 : h + 1, 2 : w + 2] - 4.0 * x)


def hfen_laplacian(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """High-frequency error norm with the fixed 3x3 Laplacian."""
    lp = _laplacian(pred.float())
    lt = _laplacian(target.float())
    return torch.linalg.norm((lt - lp).ravel()) / torch.linalg.norm(lt.ravel())


def compute_mri_metrics(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0):
    """(PSNR, SSIM, NMSE, HFEN) of ``[B, C, H, W]`` tensors, over the whole batch."""
    return (
        psnr(pred, target, data_range),
        ssim(pred, target, data_range),
        nmse(pred, target),
        hfen_laplacian(pred, target),
    )


def compute_mri_metrics_per_image(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0):
    """Per-image (PSNR, SSIM, NMSE, HFEN), each ``[B]``: :func:`compute_mri_metrics` of each
    one-image batch (batch PSNR pools the MSE before the log, so it is not the mean of these)."""
    per = [compute_mri_metrics(p[None], t[None], data_range) for p, t in zip(pred, target)]
    return tuple(torch.stack(vals) for vals in zip(*per))


def hfen_log(pred: np.ndarray, target: np.ndarray, sigma: float = 1.5) -> float:
    """HFEN with a Laplacian-of-Gaussian filter (the folder evaluator's; scipy's gaussian with
    mode 'nearest', truncate 4, then its 3x3 laplace with mode 'reflect'), in float64."""
    from scipy.ndimage import gaussian_filter, laplace

    lo_p = laplace(gaussian_filter(np.asarray(pred, np.float64), sigma=sigma, mode="nearest"))
    lo_t = laplace(gaussian_filter(np.asarray(target, np.float64), sigma=sigma, mode="nearest"))
    num = np.linalg.norm(lo_p - lo_t)
    den = np.linalg.norm(lo_t)
    return float(num / (den + 1e-8))
