"""DDPM forward-process math (port of ``mrisr_tpu/diffusion/ddpm.py``).

The ancestral ``p_step`` chain is not ported yet; the serving chain uses DDIM.
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
