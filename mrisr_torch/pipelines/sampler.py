"""Reverse-diffusion samplers (port of ``mrisr_tpu/pipelines/sampler.py``).

Each chain is a Python loop over the spaced timestep table; the denoiser is
called once per step.  ``eps_fn`` signatures:

* integer-t samplers: ``eps_fn(x_t, t[B]) -> eps``;
* SR3 samplers: ``eps_fn(x_t, gamma[B]) -> eps``.

The Res-SRDiff chain (:func:`res_shift_sample`) takes its starting noise and
its per-step noises as tensors or draws them from a generator.
"""
from __future__ import annotations

from typing import Callable

import torch

from mrisr_torch.diffusion.ddim import ddim_step
from mrisr_torch.diffusion.ddpm import p_step
from mrisr_torch.diffusion.res_shift import shift_forward, shift_reverse_step
from mrisr_torch.diffusion.schedules import Schedule, spaced_timesteps


def _pairs(timesteps) -> list[tuple[int, int]]:
    """(t, t_prev) for a descending timestep table; the final t_prev is -1."""
    ts = [int(t) for t in timesteps]
    return list(zip(ts, ts[1:] + [-1]))


def _ancestral(sched, eps_fn, x_T, generator, noise, clip_x0, cond_of):
    """The full-length ancestral chain over t = T-1 .. 0: ``eps_fn(x, cond_of(t[B]))`` then
    :func:`p_step`.  Each step's noise is ``noise[i]`` when ``noise`` (``[T, *x_T.shape]``) is
    given, else a float32 draw from ``generator``."""
    T = sched.num_timesteps
    if noise is not None and tuple(noise.shape) != (T, *x_T.shape):
        raise ValueError(f"noise must be [{T}, *{tuple(x_T.shape)}], got {tuple(noise.shape)}")
    x = x_T
    for i, t in enumerate(range(T - 1, -1, -1)):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        z = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x = p_step(sched, x, tb, eps_fn(x, cond_of(tb)), z, clip_x0)
    return x


def ddpm_sample(
    sched: Schedule,
    eps_fn: Callable,
    x_T: torch.Tensor,
    generator: torch.Generator | None = None,
    clip_x0: bool = True,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full-length ancestral DDPM chain (T steps), ``eps_fn(x_t, t[B])``."""
    return _ancestral(sched, eps_fn, x_T, generator, noise, clip_x0, lambda tb: tb)


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
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """SR3 chain: the denoiser is conditioned on gamma = sqrt(alpha_bar_t).

    An integer ``num_steps`` runs the spaced DDIM chain (eta 0; it draws no
    noise).  ``num_steps=None`` runs the full schedule ancestrally (the
    reference's 1000-step chain), its noise from ``generator`` or ``noise``
    as :func:`ddpm_sample`.
    """
    if num_steps is None:
        return _ancestral(sched, eps_fn, x_T, generator, noise, clip_x0,
                          lambda tb: sched.sqrt_alphas_cumprod[tb])
    x = x_T
    full = lambda v: torch.full((x.shape[0],), v, dtype=torch.long, device=x.device)  # noqa: E731
    for t, tp in _pairs(spaced_timesteps(sched.num_timesteps, num_steps, spacing)):
        tb, tpb = full(t), full(tp)
        eps = eps_fn(x, sched.sqrt_alphas_cumprod[tb])
        x = ddim_step(sched, x, tb, tpb, eps, None, 0.0, clip_x0)
    return x


def res_shift_sample(
    sched: Schedule,
    eps_fn: Callable,
    lr_anchor: torch.Tensor,
    noise0: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
    num_steps: int = 20,
    spacing: str = "leading",
    prediction_type: str = "epsilon",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Res-SRDiff reverse chain anchored on the LR latents, ``eps_fn(x_t, t[B])``.

    Starts from the shifted state at the first timestep (``x_T ~ LR +
    noise``) and steps the reverse process; ``t_prev`` is 0 (not -1) on the
    last step, as the reference's.  ``noise0`` (``lr_anchor``'s shape) and
    ``step_noise`` (``[num_steps, *lr_anchor.shape]``, float32) are drawn
    from ``generator`` when not given: the start first, then the steps' in one draw.
    """
    shape = tuple(lr_anchor.shape)
    if step_noise is not None and tuple(step_noise.shape) != (num_steps, *shape):
        raise ValueError(f"step_noise must be [{num_steps}, *{shape}], got {tuple(step_noise.shape)}")

    def draw(s):
        return torch.randn(s, generator=generator, device=lr_anchor.device, dtype=torch.float32)

    x0_noise = draw(shape) if noise0 is None else noise0
    if step_noise is None:
        step_noise = draw((num_steps, *shape))
    pairs = [(t, max(tp, 0)) for t, tp in _pairs(spaced_timesteps(sched.num_timesteps, num_steps, spacing))]
    full = lambda v: torch.full((shape[0],), v, dtype=torch.long, device=lr_anchor.device)  # noqa: E731
    x = shift_forward(sched, lr_anchor, lr_anchor, full(pairs[0][0]), x0_noise)
    for i, (t, tp) in enumerate(pairs):
        tb, tpb = full(t), full(tp)
        x = shift_reverse_step(sched, x, lr_anchor, tb, tpb, eps_fn(x, tb), step_noise[i], prediction_type)
    return x
