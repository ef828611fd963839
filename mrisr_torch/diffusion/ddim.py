"""DDIM sampling step (port of ``mrisr_tpu/diffusion/ddim.py``)."""
from __future__ import annotations

import torch

from mrisr_torch.diffusion.ddpm import predict_x0_from_eps
from mrisr_torch.diffusion.schedules import Schedule, extract


def ddim_step(
    sched: Schedule,
    x_t: torch.Tensor,
    t: torch.Tensor,
    t_prev: torch.Tensor,
    eps_pred: torch.Tensor,
    generator: torch.Generator | None = None,
    eta: float = 0.0,
    clip_x0: bool = True,
) -> torch.Tensor:
    """One DDIM step from timestep ``t`` to ``t_prev`` (``t_prev < 0``: to x0).

    Computes in float32 and returns the carry's dtype.  ``eta > 0`` draws its
    noise from ``generator``.
    """
    nd = x_t.ndim
    x = x_t.float()
    ac_t = extract(sched.alphas_cumprod, t, nd)
    tp = t_prev.reshape(t_prev.shape + (1,) * (nd - t_prev.ndim))
    ac_prev = torch.where(
        tp >= 0, extract(sched.alphas_cumprod, t_prev.clamp(min=0), nd), torch.ones_like(ac_t)
    )

    x0 = predict_x0_from_eps(sched, x, t, eps_pred.float())
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
    # Recompute eps from the (possibly clipped) x0 for consistency.
    eps = (x - ac_t.sqrt() * x0) / (1.0 - ac_t).sqrt()

    sigma = eta * ((1.0 - ac_prev) / (1.0 - ac_t)).sqrt() * (1.0 - ac_t / ac_prev).sqrt()
    dir_xt = (1.0 - ac_prev - sigma**2).clamp(min=0.0).sqrt() * eps
    x_prev = ac_prev.sqrt() * x0 + dir_xt
    if eta > 0.0:
        if generator is None:
            raise ValueError("eta > 0 requires a torch.Generator")
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x_prev = x_prev + sigma * noise
    return x_prev.to(x_t.dtype)
