"""Res-SRDiff residual-shifting diffusion (port of ``mrisr_tpu/diffusion/res_shift.py``).

* forward: ``x_t = sqrt(ac_t) HR + (1 - sqrt(ac_t)) LR + sqrt(1 - ac_t) eps``;
* reverse: ``x0`` from the model output (``"epsilon"``: derived, ``"sample"``:
  the output itself), re-anchored as
  ``x_{t-1} = sqrt(ac_prev) x0 + (1 - sqrt(ac_prev)) LR``, plus the DDPM
  posterior standard deviation times the step noise where ``t_prev > 0``.

The step noise is a float32 tensor drawn by the caller, so a test can hand in
another framework's draw and a CUDA graph can read it from a static buffer.
Every function computes in float32 and returns its carry's dtype.
"""
from __future__ import annotations

import torch

from mrisr_torch.diffusion.schedules import Schedule, extract


def shift_forward(
    sched: Schedule, hr: torch.Tensor, lr: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Shifted forward process: from HR toward LR as t grows; returns ``hr``'s dtype."""
    ac = extract(sched.alphas_cumprod, t, hr.ndim)
    sa = torch.sqrt(ac)
    mu = sa * hr.float() + (1.0 - sa) * lr.float()
    return (mu + torch.sqrt(1.0 - ac) * noise.float()).to(hr.dtype)


def predict_x0(
    sched: Schedule, x_t: torch.Tensor, lr: torch.Tensor, t: torch.Tensor, eps_pred: torch.Tensor
) -> torch.Tensor:
    """``x0`` from an eps prediction, float32."""
    ac = extract(sched.alphas_cumprod, t, x_t.ndim)
    sa = torch.sqrt(ac)
    return (x_t.float() - (1.0 - sa) * lr.float() - torch.sqrt(1.0 - ac) * eps_pred.float()) / sa


def shift_reverse_step(
    sched: Schedule,
    x_t: torch.Tensor,
    lr: torch.Tensor,
    t: torch.Tensor,
    t_prev: torch.Tensor,
    model_out: torch.Tensor,
    noise: torch.Tensor,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """One reverse shifting step, branch-free over ``t_prev > 0``.

    ``noise`` is a float32 standard-normal draw of ``x_t``'s shape; it is
    masked out where ``t_prev <= 0``.
    """
    nd = x_t.ndim
    ac_t = extract(sched.alphas_cumprod, t, nd)
    ac_prev = extract(sched.alphas_cumprod, t_prev.clamp(min=0), nd)
    if prediction_type == "sample":
        x0 = model_out.float()
    elif prediction_type == "epsilon":
        x0 = predict_x0(sched, x_t, lr, t, model_out)
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    sa_prev = torch.sqrt(ac_prev)
    x_prev = sa_prev * x0 + (1.0 - sa_prev) * lr.float()
    std = torch.sqrt(((1.0 - ac_prev) / (1.0 - ac_t) * (1.0 - ac_t / ac_prev)).clamp(min=0.0))
    add = (t_prev > 0).float().reshape(t_prev.shape + (1,) * (nd - t_prev.ndim))
    return (x_prev + add * std * noise.float()).to(x_t.dtype)
