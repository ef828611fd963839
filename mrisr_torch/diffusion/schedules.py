"""Diffusion noise schedules (port of ``mrisr_tpu/diffusion/schedules.py``).

The beta ramps are computed in float64 numpy, exactly as the reference does,
and stored as tensors of ``dtype`` (float32 by default), so both packages hold
the same table values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch


@dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion schedule quantities, all shape ``[T]``."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor  # shifted; alphas_cumprod_prev[0] == 1
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor  # coefficient of x0
    posterior_mean_coef2: torch.Tensor  # coefficient of x_t

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device: str | torch.device) -> "Schedule":
        return Schedule(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def linear_betas(start: float, end: float, timesteps: int) -> np.ndarray:
    return np.linspace(start, end, timesteps, dtype=np.float64)


def scaled_linear_betas(start: float, end: float, timesteps: int) -> np.ndarray:
    """Diffusers 'scaled_linear' (Stable Diffusion): linear in sqrt-beta."""
    return np.linspace(start**0.5, end**0.5, timesteps, dtype=np.float64) ** 2


def cosine_betas(timesteps: int, s: float = 0.008, max_beta: float = 0.999) -> np.ndarray:
    """Nichol & Dhariwal squared-cosine schedule (diffusers 'squaredcos_cap_v2')."""

    def bar(t):
        return math.cos((t + s) / (1 + s) * math.pi / 2) ** 2

    betas = [
        min(1 - bar((i + 1) / timesteps) / bar(i / timesteps), max_beta)
        for i in range(timesteps)
    ]
    return np.asarray(betas, dtype=np.float64)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (Lin et al. 2023)."""
    betas = np.asarray(betas, dtype=np.float64)
    sqrt_ac = np.sqrt(np.cumprod(1.0 - betas))
    sqrt_ac_0, sqrt_ac_T = sqrt_ac[0], sqrt_ac[-1]
    sqrt_ac = (sqrt_ac - sqrt_ac_T) * sqrt_ac_0 / (sqrt_ac_0 - sqrt_ac_T)
    alphas_cumprod = sqrt_ac**2
    alphas = np.empty_like(alphas_cumprod)
    alphas[0] = alphas_cumprod[0]
    alphas[1:] = alphas_cumprod[1:] / alphas_cumprod[:-1]
    return 1.0 - alphas


def make_schedule(
    kind: str = "linear",
    timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    zero_terminal_snr: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Schedule:
    """Build a :class:`Schedule` (on the CPU; move it with ``.to``)."""
    if kind == "linear":
        betas = linear_betas(beta_start, beta_end, timesteps)
    elif kind == "scaled_linear":
        betas = scaled_linear_betas(beta_start, beta_end, timesteps)
    elif kind in ("cosine", "squaredcos_cap_v2"):
        betas = cosine_betas(timesteps)
    else:
        raise ValueError(f"unknown schedule kind: {kind!r}")
    if zero_terminal_snr:
        betas = rescale_zero_terminal_snr(betas)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # log-variance clipped at t=0 (variance is 0 there) following DDPM practice.
    posterior_log_variance_clipped = np.log(
        np.maximum(posterior_variance, posterior_variance[1] if timesteps > 1 else 1e-20)
    )
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    return Schedule(
        betas=t(betas),
        alphas=t(alphas),
        alphas_cumprod=t(alphas_cumprod),
        alphas_cumprod_prev=t(alphas_cumprod_prev),
        sqrt_alphas_cumprod=t(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=t(np.sqrt(1.0 - alphas_cumprod)),
        posterior_variance=t(posterior_variance),
        posterior_log_variance_clipped=t(posterior_log_variance_clipped),
        posterior_mean_coef1=t(posterior_mean_coef1),
        posterior_mean_coef2=t(posterior_mean_coef2),
    )


def mnist_schedule(timesteps: int = 1000) -> Schedule:
    return make_schedule("linear", timesteps, 1e-4, 0.02)


def resdiff_schedule(timesteps: int = 1000) -> Schedule:
    """ResDiff/SR3 schedule: linear 1e-6 -> 1e-2."""
    return make_schedule("linear", timesteps, 1e-6, 1e-2)


def sd15_schedule(zero_terminal_snr: bool = True, timesteps: int = 1000) -> Schedule:
    return make_schedule(
        "scaled_linear", timesteps, 0.00085, 0.012, zero_terminal_snr=zero_terminal_snr
    )


def spaced_timesteps(
    train_timesteps: int, num_inference_steps: int, spacing: str = "trailing"
) -> np.ndarray:
    """Inference timestep subsequence, descending, diffusers semantics."""
    T, n = train_timesteps, num_inference_steps
    if n > T:
        raise ValueError(f"num_inference_steps {n} > train timesteps {T}")
    if spacing == "leading":
        ts = (np.arange(n) * (T // n)).round()[::-1].astype(np.int64)
    elif spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / n)).astype(np.int64) - 1
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, n).round()[::-1].astype(np.int64)
    else:
        raise ValueError(f"unknown timestep spacing: {spacing!r}")
    return ts


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather ``a[t]`` and reshape to ``[B, 1, ..., 1]`` with ``ndim`` dims."""
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))
