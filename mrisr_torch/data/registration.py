"""Rigid registration and resampling for LR -> HR alignment (port of ``mrisr_tpu/data/registration.py``).

* :func:`register_rigid`: SimpleITK's Mattes-MI rigid registration where
  SimpleITK imports, as in the reference; otherwise
  :func:`register_rigid_torch`;
* :func:`register_rigid_torch`: rigid (3 Euler angles, 3 translations)
  registration by gradient descent (Adam) on the negative normalised cross
  correlation at a coarse grid, with trilinear resampling, on the CUDA card
  by default; the transform found is applied at full resolution;
* :func:`resample_to_grid`: an identity-transform resample onto a target grid
  (``jax.image.resize``'s linear rule, ``ops/resize.py::resize_linear``).

The gradient is the JAX package's: the clip of the sample coordinates to the
volume gives 0.5 at a tie with a bound, as ``jnp.clip`` does (torch's
``clamp`` gives 1).  At the identity every border voxel lies exactly on a
bound, so the first step depends on it.  ``floor`` and the upper corner's
clamp carry no gradient; only the fractional part does.  The optimizer is
optax's Adam written out (eps outside the square root), intensities are
normalised with the population standard deviation, and the coarse grid is
made by ``resize_linear`` (antialiased when it shrinks), all as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from mrisr_torch.device import resolve_device
from mrisr_torch.ops.resize import resize_linear

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _has_sitk() -> bool:
    try:
        import SimpleITK  # noqa: F401

        return True
    except ImportError:
        return False


def register_rigid(fixed: np.ndarray, moving: np.ndarray, device: str | torch.device = "cuda", **kw) -> np.ndarray:
    """The best rigid registration available of ``moving`` onto ``fixed``'s grid."""
    if _has_sitk():
        return _register_sitk(fixed, moving, **kw)
    return register_rigid_torch(fixed, moving, device=device, **kw)


def _register_sitk(fixed: np.ndarray, moving: np.ndarray, iterations: int = 200, **_) -> np.ndarray:
    import SimpleITK as sitk

    f = sitk.GetImageFromArray(fixed.astype(np.float32))
    m = sitk.GetImageFromArray(moving.astype(np.float32))
    init = sitk.CenteredTransformInitializer(f, m, sitk.Euler3DTransform(),
                                             sitk.CenteredTransformInitializerFilter.GEOMETRY)
    reg = sitk.ImageRegistrationMethod()
    reg.SetMetricAsMattesMutualInformation(numberOfHistogramBins=50)
    reg.SetMetricSamplingStrategy(reg.RANDOM)
    reg.SetMetricSamplingPercentage(0.05)
    reg.SetInterpolator(sitk.sitkLinear)
    reg.SetOptimizerAsRegularStepGradientDescent(learningRate=2.0, minStep=1e-4, numberOfIterations=iterations)
    reg.SetOptimizerScalesFromPhysicalShift()
    reg.SetInitialTransform(init, inPlace=True)
    reg.Execute(f, m)
    out = sitk.Resample(m, f, init, sitk.sitkLinear, 0.0, m.GetPixelID())
    return sitk.GetArrayFromImage(out)


class _JaxClip(torch.autograd.Function):
    """``minimum(maximum(x, lo), hi)`` with ``jnp.clip``'s gradient: 1 strictly inside, 0.5 at a tie with
    a bound (0.25 at both), 0 outside."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        m = torch.maximum(x, lo)
        ctx.save_for_backward(x, lo, hi, m)
        return torch.minimum(m, hi)

    @staticmethod
    def backward(ctx, g):
        x, lo, hi, m = ctx.saved_tensors
        d_max = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
        d_min = torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
        return g * (d_max * d_min), None, None


def _euler_matrix(angles: torch.Tensor) -> torch.Tensor:
    ax, ay, az = angles[0], angles[1], angles[2]
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    cx, sx, cy, sy, cz, sz = torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay), torch.cos(az), torch.sin(az)
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, -sx]), torch.stack([zero, sx, cx])])
    ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]), torch.stack([-sy, zero, cy])])
    rz = torch.stack([torch.stack([cz, -sz, zero]), torch.stack([sz, cz, zero]), torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def _trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``vol`` ``[D, H, W]`` sampled at continuous ``coords`` ``[3, N]`` (clamped to the edge)."""
    top = torch.tensor(vol.shape, device=vol.device) - 1
    c = _JaxClip.apply(coords, torch.zeros((), dtype=coords.dtype, device=coords.device),
                       top[:, None].to(coords.dtype))
    c0 = torch.floor(c.detach())
    f = c - c0
    c0 = c0.long()
    c1 = torch.minimum(c0 + 1, top[:, None])
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zz, yy, xx = (c1[0] if dz else c0[0]), (c1[1] if dy else c0[1]), (c1[2] if dx else c0[2])
                w = (f[0] if dz else 1 - f[0]) * (f[1] if dy else 1 - f[1]) * (f[2] if dx else 1 - f[2])
                out = out + w * vol[zz, yy, xx]
    return out


def _transform_and_sample(moving: torch.Tensor, params: torch.Tensor, out_shape: tuple[int, int, int]) -> torch.Tensor:
    """``moving`` sampled on an ``out_shape`` grid at ``R (x - c) + c + t`` (R from ``params[:3]``, t =
    ``params[3:]``, c the grid's center).  The 3x3 product is written out, so it stays fp32 on the card."""
    dev = moving.device
    rot = _euler_matrix(params[:3])
    center = (torch.tensor(out_shape, dtype=torch.float32, device=dev) - 1) / 2.0
    idx = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev) for s in out_shape],
                                     indexing="ij")).reshape(3, -1)
    rel = idx - center[:, None]
    src = torch.stack([rot[i, 0] * rel[0] + rot[i, 1] * rel[1] + rot[i, 2] * rel[2] for i in range(3)])
    src = src + center[:, None] + params[3:, None]
    return _trilinear_sample(moving, src).reshape(out_shape)


def _normalised(x: torch.Tensor) -> torch.Tensor:
    return (x - x.mean()) / (x.std(correction=0) + 1e-6)


def rigid_params(
    fixed: np.ndarray,
    moving: np.ndarray,
    iterations: int = 150,
    lr: float = 0.05,
    downsample: int = 4,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The rigid transform from ``fixed``'s grid to ``moving``'s voxels that maximises their normalised
    cross correlation: 3 Euler angles (radians) and 3 translations (voxels of ``fixed``'s grid), fitted at a
    grid ``downsample`` times coarser (at least 8 a side) from the identity by ``iterations`` Adam steps."""
    dev = resolve_device(device)
    f = _normalised(torch.from_numpy(np.array(fixed, np.float32)).to(dev))
    m = _normalised(torch.from_numpy(np.array(moving, np.float32)).to(dev))
    small = tuple(max(8, s // downsample) for s in fixed.shape)
    f_small, m_small = resize_linear(f, small), resize_linear(m, small)

    def loss_fn(p):
        return -torch.mean(_normalised(_transform_and_sample(m_small, p, small)) * f_small)

    params = torch.zeros(6, dtype=torch.float32, device=dev)
    mu, nu = torch.zeros_like(params), torch.zeros_like(params)
    b1, b2 = torch.tensor(ADAM_B1, device=dev), torch.tensor(ADAM_B2, device=dev)
    for t in range(1, iterations + 1):
        p = params.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(p), p)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        mu_hat, nu_hat = mu / (1 - b1**t), nu / (1 - b2**t)
        params = params + (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)) * -lr
    scale = torch.tensor([fs / ss for fs, ss in zip(fixed.shape, small)], dtype=torch.float32, device=dev)
    return torch.cat([params[:3], params[3:] * scale])


def warp_rigid(moving: np.ndarray, params: torch.Tensor, out_shape: tuple[int, int, int]) -> np.ndarray:
    """``moving`` resampled on an ``out_shape`` grid through :func:`rigid_params`' transform."""
    with torch.no_grad():
        m = torch.from_numpy(np.array(moving, np.float32)).to(params.device)
        return _transform_and_sample(m, params, tuple(out_shape)).cpu().numpy()


def register_rigid_torch(
    fixed: np.ndarray,
    moving: np.ndarray,
    iterations: int = 150,
    lr: float = 0.05,
    downsample: int = 4,
    device: str | torch.device = "cuda",
    **_,
) -> np.ndarray:
    """``moving`` registered rigidly onto ``fixed``'s grid (:func:`rigid_params`, then :func:`warp_rigid` at
    full resolution)."""
    params = rigid_params(fixed, moving, iterations, lr, downsample, device)
    return warp_rigid(moving, params, fixed.shape)


def resample_to_grid(moving: np.ndarray, out_shape: tuple[int, int, int], device: str | torch.device = "cuda") -> np.ndarray:
    """Identity-transform linear resample of ``moving`` onto an ``out_shape`` grid."""
    x = torch.from_numpy(np.array(moving, np.float32)).to(resolve_device(device))
    return resize_linear(x, tuple(out_shape)).cpu().numpy()
