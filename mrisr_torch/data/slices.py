"""Volume -> 2-D slice extraction, padding / cropping and intensity windows.

The port's own copy of ``mrisr_tpu/data/slices.py`` (numpy only), with the
reference's preprocessing semantics:

* ``scale_intensity_range``: MONAI ``ScaleIntensityRangeD`` linear window
  with clipping;
* ``clip_to_unit_interval`` + ``to_minus_one_one``: the per-modality clip
  then the [-1, 1] mapping of the slice dataset;
* ``pad_or_center_crop``: to 512x512 (by default) with pad value -1.0;
* ``crop_slab``: the [80 : D-30] air-removal crop;
* ``volume_to_slices``: paired slicing along an axis with HR index
  ``i * scale``.
"""
from __future__ import annotations

import numpy as np


def scale_intensity_range(
    x: np.ndarray, a_min: float, a_max: float, b_min: float = 0.0, b_max: float = 1.0
) -> np.ndarray:
    y = (x.astype(np.float32) - a_min) / (a_max - a_min)
    y = y * (b_max - b_min) + b_min
    return np.clip(y, min(b_min, b_max), max(b_min, b_max))


def clip_to_unit_interval(x: np.ndarray, clip: tuple[float, float]) -> np.ndarray:
    a_min, a_max = float(clip[0]), float(clip[1])
    return np.clip((x.astype(np.float32) - a_min) / (a_max - a_min), 0.0, 1.0)


def to_minus_one_one(x01: np.ndarray) -> np.ndarray:
    return (x01 * 2.0 - 1.0).astype(np.float32)


def pad_or_center_crop(
    img: np.ndarray, target: tuple[int, int] = (512, 512), pad_value: float = -1.0
) -> np.ndarray:
    """Center-crop then symmetric constant-pad a 2D array to ``target``."""
    th, tw = target
    h, w = img.shape
    if h > th:
        s = (h - th) // 2
        img = img[s : s + th]
        h = th
    if w > tw:
        s = (w - tw) // 2
        img = img[:, s : s + tw]
        w = tw
    ph, pw = th - h, tw - w
    if ph or pw:
        img = np.pad(
            img,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)),
            constant_values=pad_value,
        )
    return img


def crop_slab(vol: np.ndarray, axis: int, start: int = 80, end_margin: int = 30) -> np.ndarray:
    """Crop ``[start : D - end_margin]`` along ``axis``; no-op if too small."""
    d = vol.shape[axis]
    stop = d - end_margin
    if stop <= start or d <= start - end_margin + 10:
        return vol
    sl = [slice(None)] * vol.ndim
    sl[axis] = slice(start, stop)
    return vol[tuple(sl)]


def volume_to_slices(
    lr_vol: np.ndarray, hr_vol: np.ndarray, axis: int = 2
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Paired 2D slices along ``axis``; HR indexed at ``i * scale``.

    ``scale = hr.shape[axis] // lr.shape[axis]`` — after the reference's
    (512,512,128) resize this is 1 and LR/HR share the grid.
    """
    scale = max(1, hr_vol.shape[axis] // lr_vol.shape[axis])
    out = []
    for i in range(lr_vol.shape[axis]):
        li = [slice(None)] * lr_vol.ndim
        li[axis] = i
        hi = [slice(None)] * hr_vol.ndim
        hi[axis] = min(i * scale, hr_vol.shape[axis] - 1)
        out.append((lr_vol[tuple(li)], hr_vol[tuple(hi)]))
    return out
