"""DDPM forward and reverse process math (port of ``mrisr_tpu/diffusion/ddpm.py``).

``p_step`` takes its Gaussian noise as a tensor drawn by the caller, so a test
can hand it another framework's draw.
"""
from __future__ import annotations

import torch

from mrisr_torch.diffusion.schedules import Schedule, extract


def q_sample(sched: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Diffuse ``x0`` to timestep ``t``: ``sqrt(ac_t) x0 + sqrt(1-ac_t) eps``."""
    a = extract(sched.sqrt_alphas_cumprod, t, x0.ndim)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
    return a * x0 + s * noise


def predict_x0_from_eps(sched: Schedule, x_t, t, eps):
    a = extract(sched.sqrt_alphas_cumprod, t, x_t.ndim)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
    return (x_t - s * eps) / a


def predict_eps_from_x0(sched: Schedule, x_t, t, x0):
    a = extract(sched.sqrt_alphas_cumprod, t, x_t.ndim)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim)
    return (x_t - a * x0) / s


def posterior_mean_variance(sched: Schedule, x0, x_t, t):
    """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x0)."""
    mean = (
        extract(sched.posterior_mean_coef1, t, x_t.ndim) * x0
        + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )
    var = extract(sched.posterior_variance, t, x_t.ndim)
    log_var = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def p_step(
    sched: Schedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    eps_pred: torch.Tensor,
    noise: torch.Tensor,
    clip_x0: bool = True,
) -> torch.Tensor:
    """One ancestral DDPM reverse step from ``x_t`` to ``x_{t-1}``.

    ``noise`` is a standard normal draw of ``x_t``'s shape; it is masked out
    where ``t == 0``.  Computes in float32 and returns the carry's dtype.
    """
    x = x_t.float()
    x0 = predict_x0_from_eps(sched, x, t, eps_pred.float())
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    mean, _, log_var = posterior_mean_variance(sched, x0, x, t)
    nonzero = (t > 0).float().reshape(t.shape + (1,) * (x.ndim - t.ndim))
    out = mean + nonzero * torch.exp(0.5 * log_var) * noise.float()
    return out.to(x_t.dtype)
