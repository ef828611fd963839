"""Haar DWT as fixed 2x2 block transforms (port of ``mrisr_tpu/ops/wavelets.py``).

Convention (pywt haar): approximation = (even + odd)/sqrt(2) and detail =
(even - odd)/sqrt(2) along each axis; bands are ordered (LH, HL, HH).
"""
from __future__ import annotations

import torch


def haar_dwt_level(x: torch.Tensor):
    """One level of ``[..., H, W]`` -> (LL, (LH, HL, HH)), each ``[..., H/2, W/2]``."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"haar DWT requires even spatial dims, got {h}x{w}")
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    a = x[..., 0, :, 0]  # even row, even col
    b = x[..., 0, :, 1]  # even row, odd col
    c = x[..., 1, :, 0]  # odd row, even col
    d = x[..., 1, :, 1]  # odd row, odd col
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5
    hl = (a + b - c - d) * 0.5
    hh = (a - b - c + d) * 0.5
    return ll, (lh, hl, hh)


def haar_dwt_highpass_sum(x: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Sum of the three band-pass sub-bands at each of ``levels`` DWT levels."""
    out = []
    cur = x
    for _ in range(levels):
        cur, (lh, hl, hh) = haar_dwt_level(cur)
        out.append(lh + hl + hh)
    return out
