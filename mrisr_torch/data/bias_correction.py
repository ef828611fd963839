"""N4-style MRI bias-field correction in numpy and scipy (port of ``mrisr_tpu/data/bias_correction.py``).

The reference corrects intensity inhomogeneity with SimpleITK's
``N4BiasFieldCorrectionImageFilter``; this is the same algorithm family
(Sled's N3 / Tustison's N4), as the JAX package implements it:

1. work on the log image: ``log v = log u + log f`` (the bias multiplies);
2. each iteration sharpens the log-intensity histogram by Wiener
   deconvolution with a Gaussian of the given FWHM (ITK's defaults:
   ``bias_fwhm=0.15``, ``wiener_noise=0.01``, 200 bins) and maps every voxel
   to its conditional expectation E[u|v] under the sharpened density;
3. the residual ``log v - E[log u | log v]`` is fitted with a smooth field:
   a coarse control grid (``control_points`` per axis, Gaussian-regularised,
   upsampled with cubic interpolation) in place of N4's B-spline mesh;
4. the accumulated field is normalised to zero log-mean and subtracted,
   until the update is small or the iteration budget is spent.

It runs on the host, before registration, like the reference's ITK call.
"""
from __future__ import annotations

import numpy as np


def _smooth_field(residual: np.ndarray, mask: np.ndarray, control_points: int) -> np.ndarray:
    """Fit a smooth low-frequency field to ``residual`` over ``mask``.

    Masked coarse averaging onto a ``control_points``-per-axis grid followed
    by cubic upsampling — a B-spline-mesh stand-in with the same role.
    """
    from scipy import ndimage

    shape = residual.shape
    filled = np.where(mask, residual, 0.0)
    weight = mask.astype(np.float64)

    zoom = [control_points / s for s in shape]
    coarse_num = ndimage.zoom(ndimage.gaussian_filter(filled, 2.0), zoom, order=1)
    coarse_den = ndimage.zoom(ndimage.gaussian_filter(weight, 2.0), zoom, order=1)
    coarse = coarse_num / np.maximum(coarse_den, 1e-6)
    coarse = ndimage.gaussian_filter(coarse, 1.0)

    up = ndimage.zoom(coarse, [s / c for s, c in zip(shape, coarse.shape)], order=3)
    # zoom rounding can be off by one voxel; crop/pad to match
    slices = tuple(slice(0, s) for s in shape)
    out = np.zeros(shape, np.float64)
    src = up[slices]
    out[tuple(slice(0, d) for d in src.shape)] = src
    return out


def _sharpen_log_intensities(
    log_v: np.ndarray, bias_fwhm: float, wiener_noise: float, num_bins: int
) -> np.ndarray:
    """Histogram Wiener deconvolution -> per-voxel E[log u | log v].

    (Sled 1998 §II.C / Tustison 2010 eq. 3-5 semantics.)
    """
    lo, hi = float(log_v.min()), float(log_v.max())
    if hi - lo < 1e-6:
        return log_v
    hist, edges = np.histogram(log_v, bins=num_bins, range=(lo, hi))
    hist = hist.astype(np.float64)
    centers = 0.5 * (edges[:-1] + edges[1:])
    width = centers[1] - centers[0]

    # Gaussian blur kernel in histogram space
    sigma = bias_fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    pad = num_bins  # linear (non-circular) deconvolution via zero padding
    n = 2 * num_bins + pad
    offsets = (np.arange(n) + n // 2) % n - n // 2
    g = np.exp(-0.5 * (offsets * width / sigma) ** 2)
    g /= g.sum()

    F = np.fft.fft(g)
    V = np.fft.fft(hist, n)
    # Wiener deconvolution: U = V * conj(F) / (|F|^2 + noise)
    U = V * np.conj(F) / (np.abs(F) ** 2 + wiener_noise)
    u = np.maximum(np.real(np.fft.ifft(U))[:num_bins], 0.0)

    # E[u-bin | v-bin]: numerator/denominator re-blurred with the kernel
    num = np.real(np.fft.ifft(np.fft.fft(u * centers, n) * F))[:num_bins]
    den = np.real(np.fft.ifft(np.fft.fft(u, n) * F))[:num_bins]
    expect = np.where(den > 1e-12, num / np.maximum(den, 1e-12), centers)

    idx = np.clip(((log_v - lo) / width).astype(np.int64), 0, num_bins - 1)
    return expect[idx]


def n4_bias_correction(
    volume: np.ndarray,
    mask: np.ndarray | None = None,
    max_iterations: int = 25,
    convergence_threshold: float = 1e-3,
    bias_fwhm: float = 0.15,
    wiener_noise: float = 0.01,
    num_bins: int = 200,
    control_points: int = 4,
    step_size: float = 1.0,
    return_field: bool = False,
):
    """Correct multiplicative intensity inhomogeneity (N4 semantics).

    ``volume``: 2D/3D array, non-negative intensities.  ``mask``: optional
    foreground mask (default: positive voxels).  Returns the corrected
    volume (and the estimated multiplicative field when ``return_field``).
    """
    v = np.asarray(volume, np.float64)
    if mask is None:
        mask = v > 0
    mask = np.asarray(mask, bool)
    if not mask.any():
        out = v.astype(np.float32)
        return (out, np.ones_like(out)) if return_field else out

    eps = 1e-6
    log_v = np.where(mask, np.log(np.maximum(v, eps)), 0.0)
    log_field = np.zeros_like(log_v)
    current = log_v.copy()

    # A fixed iteration budget with a small-update early exit: the single-level smooth fit keeps taking a
    # roughly constant update per iteration until the bias is absorbed and then starts taking anatomy, so
    # the budget itself is the regulariser (25 is the JAX package's measured optimum on synthetic fields).
    for _ in range(max_iterations):
        sharpened = current.copy()
        sharpened[mask] = _sharpen_log_intensities(
            current[mask], bias_fwhm, wiener_noise, num_bins
        )
        residual = np.where(mask, current - sharpened, 0.0)
        delta = step_size * _smooth_field(residual, mask, control_points)
        delta -= delta[mask].mean()  # zero log-mean: field carries no gain
        log_field += delta
        current = log_v - log_field

        if float(np.std(np.exp(delta[mask]))) < convergence_threshold:
            break

    field = np.exp(log_field)
    corrected = np.where(mask, v / np.maximum(field, eps), v).astype(np.float32)
    if return_field:
        return corrected, field.astype(np.float32)
    return corrected
