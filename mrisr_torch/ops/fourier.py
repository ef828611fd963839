"""Frequency-domain helpers (port of ``mrisr_tpu/ops/fourier.py``).

The Gaussian transfer function is evaluated on a *centered* frequency grid but
applied to the *unshifted* FFT, as the reference does.  The FFT runs over
(H, W) per image in float32 (not over all dims).
"""
from __future__ import annotations

import torch


def centered_distance_grid(n: int, m: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """sqrt(u^2 + v^2) with u = row - n/2, v = col - m/2."""
    u = torch.arange(n, dtype=torch.float32, device=device) - n / 2.0
    v = torch.arange(m, dtype=torch.float32, device=device) - m / 2.0
    return torch.sqrt(u[:, None] ** 2 + v[None, :] ** 2)


def gaussian_highpass_split(x: torch.Tensor, sigma: torch.Tensor):
    """Filter ``x`` [B, C, H, W] with H = 1 - exp(-D^2 / (2 sigma^2)).

    ``sigma``: per-sample scalars broadcastable to [B, 1, 1, 1].
    Returns ``(fft_filtered, |ifft2(fft_filtered)|)``.
    """
    n, m = x.shape[-2], x.shape[-1]
    d = centered_distance_grid(n, m, x.device)
    sig = sigma.reshape(sigma.shape + (1,) * (x.ndim - sigma.ndim)).float()
    h = 1.0 - torch.exp(-(d**2) / (2.0 * sig**2))
    xf = torch.fft.fft2(x.float())
    xf_filtered = xf * h
    hf = torch.fft.ifft2(xf_filtered).abs()
    return xf_filtered, hf
