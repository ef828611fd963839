"""Plain PyTorch reference of the ResDiff training step, frozen with the benchmark.

One step on a batch of (LR, HR) slices: the stage-1 estimate ``sr`` of the LR
slices (no gradient), then, from the step's generator in this order, the
timestep ``t ~ U{0..T-1}`` a slice, ``gamma ~ U(sqrt(ac[t]), sqrt(ac[t-1]))``
(``ac[-1]`` = 1), the noise ``eps``, and the UNet's dropout masks as its
blocks run; ``x_t = gamma (hr - sr) + sqrt(1 - gamma^2) eps``, the UNet's eps
of ``cat(sr, x_t)`` against ``eps`` by mean squared error; Adam (bias
corrected) on the float32 parameters, and after each update the exponential
moving average ``ema = d ema + (1 - d) params`` from the starting weights,
kept in float32 as the configuration states.  Written with ``torch``
operations and autograd alone, in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def schedule_tables(timesteps: int, beta_start: float, beta_end: float, device):
    """sqrt(ac[t]) and sqrt(ac[t-1]) (1 at t = 0), float32, from the float64 linear ramp."""
    ac = np.cumprod(1.0 - np.linspace(beta_start, beta_end, timesteps, dtype=np.float64))
    prev = np.concatenate([[1.0], ac[:-1]])
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return torch.sqrt(t(ac)), torch.sqrt(t(prev))


def loss(cnn, unet, params, lr, hr, generator, tables):
    """The step's loss on NCHW ``lr``, ``hr`` with the UNet's parameters ``params`` (name -> tensor)."""
    from torch.func import functional_call

    lo_table, hi_table = tables
    with torch.no_grad():
        sr = cnn(lr)
    b = hr.shape[0]
    t = torch.randint(0, lo_table.shape[0], (b,), generator=generator, device=hr.device)
    lo, hi = lo_table[t], hi_table[t]
    gamma = lo + (hi - lo) * torch.rand(t.shape, generator=generator, device=hr.device)
    eps = torch.randn(hr.shape, generator=generator, device=hr.device, dtype=hr.dtype)
    g = gamma[:, None, None, None]
    x_t = g * (hr - sr) + torch.sqrt(1.0 - g ** 2) * eps

    out = functional_call(unet, params, (torch.cat([sr, x_t], dim=1), gamma), {"generator": generator})
    return torch.mean((out - eps) ** 2)


class Adam:
    """Adam with bias correction."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0

    def update(self, grads):
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            self.params[k] = self.params[k] - self.lr * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)


def train(cnn, unet, params, batches, generators, tables, lr, ema_decay):
    """Steps over ``batches`` (NCHW ``(lr, hr)``), each with its generator: ``(losses, first gradients, Adam,
    EMA)``."""
    opt = Adam(params, lr)
    ema = {k: v.detach().clone() for k, v in params.items()}
    losses, first = [], None
    for (lr_b, hr_b), gen in zip(batches, generators):
        leaves = {k: v.clone().requires_grad_(True) for k, v in opt.params.items()}
        value = loss(cnn, unet, leaves, lr_b, hr_b, gen, tables)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}
        if first is None:
            first = grads
        losses.append(float(value.detach()))
        opt.update(grads)
        ema = {k: torch.lerp(e, opt.params[k], 1.0 - ema_decay) for k, e in ema.items()}
    return losses, first, opt, ema
