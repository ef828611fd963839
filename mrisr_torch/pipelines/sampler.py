"""Reverse-diffusion samplers (port of ``mrisr_tpu/pipelines/sampler.py``).

Each chain is a Python loop over the spaced timestep table; the denoiser is
called once per step.  ``eps_fn`` signatures:

* integer-t samplers: ``eps_fn(x_t, t[B]) -> eps``;
* SR3 samplers: ``eps_fn(x_t, gamma[B]) -> eps``.
"""
from __future__ import annotations

from typing import Callable

import torch

from mrisr_torch.diffusion.ddim import ddim_step
from mrisr_torch.diffusion.schedules import Schedule, spaced_timesteps


def _pairs(timesteps) -> list[tuple[int, int]]:
    """(t, t_prev) for a descending timestep table; the final t_prev is -1."""
    ts = [int(t) for t in timesteps]
    return list(zip(ts, ts[1:] + [-1]))


def ddim_sample(
    sched: Schedule,
    eps_fn: Callable,
    x_T: torch.Tensor,
    generator: torch.Generator | None = None,
    num_steps: int = 50,
    spacing: str = "trailing",
    eta: float = 0.0,
    clip_x0: bool = True,
) -> torch.Tensor:
    """K-step DDIM chain with diffusers-style timestep spacing."""
    x = x_T
    full = lambda v: torch.full((x.shape[0],), v, dtype=torch.long, device=x.device)  # noqa: E731
    for t, tp in _pairs(spaced_timesteps(sched.num_timesteps, num_steps, spacing)):
        tb, tpb = full(t), full(tp)
        x = ddim_step(sched, x, tb, tpb, eps_fn(x, tb), generator, eta, clip_x0)
    return x


def sr3_ancestral_sample(
    sched: Schedule,
    eps_fn: Callable,
    x_T: torch.Tensor,
    num_steps: int | None = 50,
    spacing: str = "trailing",
    clip_x0: bool = True,
) -> torch.Tensor:
    """SR3 chain: the denoiser is conditioned on gamma = sqrt(alpha_bar_t).

    An integer ``num_steps`` runs the spaced DDIM chain (eta 0).  The
    full-length ancestral chain (``num_steps=None``) is not ported yet.
    """
    if num_steps is None:
        raise NotImplementedError("the full-length ancestral SR3 chain is not ported yet")
    x = x_T
    full = lambda v: torch.full((x.shape[0],), v, dtype=torch.long, device=x.device)  # noqa: E731
    for t, tp in _pairs(spaced_timesteps(sched.num_timesteps, num_steps, spacing)):
        tb, tpb = full(t), full(tp)
        eps = eps_fn(x, sched.sqrt_alphas_cumprod[tb])
        x = ddim_step(sched, x, tb, tpb, eps, None, 0.0, clip_x0)
    return x
