"""SR3 / ResDiff continuous-noise-level formulation (port of ``mrisr_tpu/diffusion/sr3.py``).

Training conditions the denoiser on a continuous noise level
``gamma = sqrt(alpha_cumprod)`` drawn uniformly between consecutive schedule
knots; ``x_t = gamma x0 + sqrt(1 - gamma^2) eps``.
"""
from __future__ import annotations

import torch

from mrisr_torch.diffusion.schedules import Schedule


def sample_gamma(sched: Schedule, t: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """``gamma ~ U(sqrt(ac[t]), sqrt(ac_prev[t]))`` for ``t`` in ``[0, T)``; ``ac_prev[0] = 1``."""
    hi = torch.sqrt(sched.alphas_cumprod_prev[t])
    lo = torch.sqrt(sched.alphas_cumprod[t])
    u = torch.rand(t.shape, generator=generator, device=t.device)
    return lo + (hi - lo) * u


def _per_batch(gamma: torch.Tensor, ndim: int) -> torch.Tensor:
    return gamma.reshape(gamma.shape + (1,) * (ndim - gamma.ndim))


def q_sample_gamma(x0: torch.Tensor, gamma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x_t = gamma * x0 + sqrt(1 - gamma^2) * eps`` with ``gamma`` per batch element."""
    g = _per_batch(gamma, x0.ndim)
    return g * x0 + torch.sqrt(1.0 - g**2) * noise


def predict_x0_from_eps_gamma(x_t: torch.Tensor, gamma: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    g = _per_batch(gamma, x_t.ndim)
    return (x_t - torch.sqrt(1.0 - g**2) * eps) / g
