"""Image resizing, blurring and pixel (un)shuffle (port of ``mrisr_tpu/ops/resize.py``).

The reference stack mixes three resampling conventions, each reproduced here:

* ``torch.nn.functional.interpolate(mode='bicubic', align_corners=False)``:
  cubic a = -0.75, no antialiasing, border taps clamped
  (:func:`interpolate_like_torch`);
* ``PIL.Image.resize(..., LANCZOS / BICUBIC)``: Lanczos-3 / cubic a = -0.5,
  antialiased on downscale, the window shrunk to valid pixels and
  renormalised (:func:`pil_resize_like`);
* ``scipy.ndimage.gaussian_filter`` with its 'reflect' boundary
  (:func:`gaussian_blur`).

Each resize is two dense ``[out, in]`` weight matrices built in numpy exactly
as the reference builds them (:func:`_resize_weights`) and applied as two
matrix products: on tensors (any device) by :func:`resize2d`, on numpy arrays
(the data path on the host) by :func:`resize2d_np`.  ``interpolate_like_torch``
keeps the reference's edge handling rather than calling ``F.interpolate``.

The reference's PIL window (``edge='shrink'``) rounds its ends half a pixel
short of PIL's, so at a non-integer scale it can drop PIL's last tap.  The
tensor form :func:`pil_resize_like` keeps the reference's window (it is held
to the JAX package); the numpy form :func:`pil_resize_like_np`, which the
data path uses instead of PIL, takes PIL's own window (``edge='pil'``) and
resamples as PIL does a float image: the horizontal pass first, each pass
summed in double and stored in float32.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Kernel functions
# ---------------------------------------------------------------------------


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _lanczos(x: np.ndarray, taps: int = 3) -> np.ndarray:
    return np.where(np.abs(x) < taps, np.sinc(x) * np.sinc(x / taps), 0.0)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _box(x: np.ndarray) -> np.ndarray:
    return ((x >= -0.5) & (x < 0.5)).astype(np.float64)


_KERNELS = {
    # (function, support)
    "bicubic_torch": (lambda x: _cubic(x, -0.75), 2.0),
    "bicubic": (lambda x: _cubic(x, -0.5), 2.0),  # PIL convention
    "lanczos": (_lanczos, 3.0),
    "bilinear": (_triangle, 1.0),
    "nearest": (_box, 0.5),
}


@functools.lru_cache(maxsize=256)
def _resize_weights(in_size: int, out_size: int, kernel: str, antialias: bool, edge: str = "clamp") -> np.ndarray:
    """:func:`_weights64` in float32, as the reference gives them."""
    return _weights64(in_size, out_size, kernel, antialias, edge).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _weights64(in_size: int, out_size: int, kernel: str, antialias: bool, edge: str = "clamp") -> np.ndarray:
    """Dense ``[out_size, in_size]`` float64 resampling matrix, rows summing to 1.

    Source coordinates follow the half-pixel convention of PIL and of torch's
    ``align_corners=False``: ``src = (dst + 0.5) * scale - 0.5``.  With
    ``antialias`` the kernel support is stretched by the downscale factor
    (PIL); without, the kernel is applied at unit scale (torch).
    ``edge='clamp'`` accumulates out-of-range taps on the border pixel
    (torch's index clamping); ``edge='shrink'`` restricts the window to valid
    pixels and renormalises over it (the reference's PIL window);
    ``edge='pil'`` is PIL's window, ``[int(c - r + 1), int(c + r + 1))`` for
    the source center ``c``.
    """
    fn, support = _KERNELS[kernel]
    scale = in_size / out_size
    filter_scale = max(scale, 1.0) if antialias else 1.0
    r = support * filter_scale

    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        if edge in ("shrink", "pil"):
            shift = 1.0 if edge == "pil" else 0.5
            lo = max(0, int(center - r + shift))
            hi = min(in_size, int(center + r + shift))
            taps = np.arange(lo, hi)
            vals = fn((taps - center) / filter_scale)
            s = vals.sum()
            if s != 0:
                vals = vals / s
            w[i, lo:hi] = vals
        else:
            lo = int(math.floor(center - r)) if kernel != "nearest" else int(math.floor(center - r + 0.5))
            hi = int(math.ceil(center + r)) + 1
            taps = np.arange(lo, hi)
            vals = fn((taps - center) / filter_scale)
            s = vals.sum()
            if s != 0:
                vals = vals / s
            np.add.at(w[i], np.clip(taps, 0, in_size - 1), vals)
    return w


def resize2d(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    kernel: str = "bicubic_torch",
    antialias: bool = False,
    edge: str = "clamp",
) -> torch.Tensor:
    """Separable 2-D resize of the trailing two dims of ``[..., H, W]``, computed in float32, returned in
    ``x``'s dtype."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    wh = torch.from_numpy(_resize_weights(h_in, h_out, kernel, antialias, edge)).to(x.device)
    ww = torch.from_numpy(_resize_weights(w_in, w_out, kernel, antialias, edge)).to(x.device)
    y = torch.matmul(wh, x.float())
    y = torch.matmul(y, ww.T)
    return y.to(x.dtype)


def resize2d_np(
    x: np.ndarray,
    out_hw: tuple[int, int],
    kernel: str = "bicubic_torch",
    antialias: bool = False,
    edge: str = "clamp",
) -> np.ndarray:
    """:func:`resize2d` on a float32 numpy array: the horizontal pass, then the vertical one, each summed in
    double and stored in float32 (PIL's order for a float image); a dimension that keeps its size is left
    alone."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    y = x.astype(np.float32)
    if w_in != out_hw[1]:
        ww = _weights64(w_in, out_hw[1], kernel, antialias, edge)
        y = np.matmul(y.astype(np.float64), ww.T).astype(np.float32)
    if h_in != out_hw[0]:
        wh = _weights64(h_in, out_hw[0], kernel, antialias, edge)
        y = np.matmul(wh, y.astype(np.float64)).astype(np.float32)
    return y


def interpolate_like_torch(x: torch.Tensor, out_hw: tuple[int, int], mode: str = "bicubic") -> torch.Tensor:
    """``F.interpolate(..., align_corners=False)`` semantics (no antialias), the reference's weights."""
    kernel = {"bicubic": "bicubic_torch", "bilinear": "bilinear", "nearest": "nearest"}[mode]
    return resize2d(x, out_hw, kernel=kernel, antialias=False)


_PIL_KERNELS = {"lanczos": "lanczos", "bicubic": "bicubic", "bilinear": "bilinear"}


def pil_resize_like(x: torch.Tensor, out_hw: tuple[int, int], filt: str = "lanczos") -> torch.Tensor:
    """``PIL.Image.resize`` semantics: the antialiased kernel (LANCZOS / BICUBIC) on a shrunk window."""
    return resize2d(x, out_hw, kernel=_PIL_KERNELS[filt], antialias=True, edge="shrink")


def pil_resize_like_np(x: np.ndarray, out_hw: tuple[int, int], filt: str = "lanczos") -> np.ndarray:
    """``PIL.Image.resize`` of a float (mode 'F') image without PIL: PIL's window and order of passes."""
    return resize2d_np(x, out_hw, kernel=_PIL_KERNELS[filt], antialias=True, edge="pil")


# ---------------------------------------------------------------------------
# Gaussian blur (scipy.ndimage semantics)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of ``[..., H, W]`` with scipy's 'reflect' boundary (symmetric half-sample
    reflection), computed in float32 as a sum of shifted slices."""
    taps = _gaussian_taps(float(sigma), truncate)
    r = (taps.shape[0] - 1) // 2
    lead = x.shape[:-2]
    y = x.float().reshape(-1, 1, *x.shape[-2:])
    y = _reflect_pad(y, r)
    n = taps.shape[0]
    h, w = y.shape[-2] - n + 1, y.shape[-1] - n + 1
    rows = sum(float(taps[i]) * y[..., i : i + h, :] for i in range(n))
    out = sum(float(taps[i]) * rows[..., :, i : i + w] for i in range(n))
    return out.reshape(*lead, *out.shape[-2:]).to(x.dtype)


def _reflect_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Symmetric padding by ``r`` on the last two dims (``numpy.pad(mode='symmetric')``), any ``r``."""
    for dim in (-2, -1):
        n = x.shape[dim]
        idx = np.arange(-r, n + r)
        period = 2 * n
        idx = np.mod(idx, period)
        idx = np.where(idx >= n, period - 1 - idx, idx)
        x = torch.index_select(x, dim, torch.from_numpy(idx).to(x.device))
    return x


# ---------------------------------------------------------------------------
# Pixel shuffle / unshuffle
# ---------------------------------------------------------------------------


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C*r^2, H, W]`` -> ``[B, C, H*r, W*r]`` (torch ``PixelShuffle`` layout)."""
    b, c, h, w = x.shape
    r = factor
    co = c // (r * r)
    return x.reshape(b, co, r, r, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b, co, h * r, w * r)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C, H*r, W*r]`` -> ``[B, C*r^2, H, W]`` (torch ``PixelUnshuffle``)."""
    b, c, hr, wr = x.shape
    r = factor
    h, w = hr // r, wr // r
    return x.reshape(b, c, h, r, w, r).permute(0, 1, 3, 5, 2, 4).reshape(b, c * r * r, h, w)
