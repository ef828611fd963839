"""Full-volume inference: NIfTI -> slices -> SR -> restack (port of ``mrisr_tpu/pipelines/volume.py``).

A volume is sliced along an axis, windowed to [-1, 1], padded or cropped to
the model resolution and cut into batches.  Each batch goes through any
pipeline with ``super_resolve(lr, generator, num_steps=...)`` (and, for
grouped dispatch, ``super_resolve_group``); the results are cropped back to
the slice shape on the pipeline's device, restacked and written as NIfTI
with the source affine.

The batch that starts at slice ``s`` draws its noise from its own generator,
seeded from ``(seed, s)`` (:func:`batch_generator`), so serial and grouped
dispatch give the same volume.  Results are copied to the host after each
call; there is no download thread.
"""
from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np
import torch

from mrisr_torch.data.nifti import NiftiImage, read_nifti, to_ras, write_nifti
from mrisr_torch.data.slices import clip_to_unit_interval, pad_or_center_crop, to_minus_one_one


def volume_to_model_slices(
    vol: np.ndarray,
    axis: int = 2,
    resolution: int = 256,
    clip: tuple[float, float] = (0, 1000),
) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """-> (slices ``[N, R, R, 1]`` in [-1, 1], the original (H, W) of each slice)."""
    slices, shapes = [], []
    for i in range(vol.shape[axis]):
        sl = [slice(None)] * vol.ndim
        sl[axis] = i
        img = vol[tuple(sl)]
        shapes.append(img.shape)
        img = to_minus_one_one(clip_to_unit_interval(img, clip))
        img = pad_or_center_crop(img, (resolution, resolution), pad_value=-1.0)
        slices.append(img[..., None])
    return np.stack(slices).astype(np.float32), shapes


def restack_slices(sr_slices: np.ndarray, shapes: list[tuple[int, int]], axis: int = 2) -> np.ndarray:
    """Undo the pad / crop of each slice and stack them back into a volume in [0, 1].

    Takes stacks already cropped to the slice shape too (the volume driver
    crops on the device).
    """
    rh, rw = sr_slices.shape[1:3]
    h0, w0 = shapes[0]
    if all(s == (h0, w0) for s in shapes) and h0 <= rh and w0 <= rw:
        # One shape for every slice (the common case): one vectorized crop.
        ph, pw = (rh - h0) // 2, (rw - w0) // 2
        vol = (sr_slices[:, ph : ph + h0, pw : pw + w0, 0] + 1.0) / 2.0
        return np.moveaxis(vol, 0, axis)
    out = []
    for i, (h, w) in enumerate(shapes):
        img = sr_slices[i, ..., 0]
        # Per dimension: a side at most the resolution was center-padded going
        # in (crop its center back out); a larger side was center-cropped
        # (put the SR patch back at the center of a canvas filled with -1,
        # the input's pad value).  A (20, 12) slice at resolution 16 is
        # cropped in h and padded in w.
        if h <= rh:
            img = img[(rh - h) // 2 : (rh - h) // 2 + h, :]
        if w <= rw:
            img = img[:, (rw - w) // 2 : (rw - w) // 2 + w]
        if img.shape != (h, w):
            canvas = np.full((h, w), -1.0, img.dtype)
            oh, ow = (h - img.shape[0]) // 2, (w - img.shape[1]) // 2
            canvas[oh : oh + img.shape[0], ow : ow + img.shape[1]] = img
            img = canvas
        out.append((img + 1.0) / 2.0)
    return np.stack(out, axis=axis)


def pipeline_dtype(pipeline) -> torch.dtype:
    """The dtype most of the pipeline's UNet parameters have (float32 without a UNet)."""
    unet = getattr(pipeline, "unet", None)
    if unet is None:
        return torch.float32
    return Counter(p.dtype for p in unet.parameters()).most_common(1)[0][0]


def batch_generator(device: torch.device, seed: int, start: int) -> torch.Generator:
    """The generator of the batch that starts at slice ``start``, seeded from ``(seed, start)``.

    The pair is mixed into 32 bits (the CPU generator keeps only the low 32
    bits of a seed).
    """
    mixed = int(np.random.SeedSequence((seed, start)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def _crop_on_device(sr: torch.Tensor, shape: tuple[int, int], resolution: int) -> torch.Tensor:
    """``[G, B, R, R, 1]`` cropped to the slices' (H, W) where both were padded up to R."""
    h, w = shape
    if h > resolution or w > resolution or (h, w) == (resolution, resolution):
        return sr
    ch, cw = (resolution - h) // 2, (resolution - w) // 2
    return sr[:, :, ch : ch + h, cw : cw + w, :]


def super_resolve_volume(
    pipeline,
    nifti_path: str | Path,
    out_path: str | Path | None = None,
    axis: int = 2,
    resolution: int = 256,
    batch_size: int = 8,
    num_steps: int = 50,
    clip: tuple[float, float] = (0, 1000),
    seed: int = 0,
    chain_group: int = 1,
) -> NiftiImage:
    """Super-resolve the volume at ``nifti_path`` slice batch by slice batch.

    The slices reach the pipeline in the dtype of most of its UNet's
    parameters (bf16 slices for a bf16 pipeline).  ``chain_group=G > 1``
    sends G batches a call through ``pipeline.super_resolve_group``; the
    last call takes the batches that are left, fewer than G when G does not
    divide their number (each chain's CUDA graph is keyed on one batch's
    shape, so a short group costs no new capture).
    """
    img = to_ras(read_nifti(nifti_path))
    vol = img.data
    dtype = pipeline_dtype(pipeline)
    device = pipeline.device

    n = vol.shape[axis]
    shapes: list = [None] * n

    def prep_batch(s: int) -> np.ndarray:
        """Window and pad one batch of slices; a batch past the last slice repeats it."""
        arrs = []
        for i in range(s, s + batch_size):
            j = min(i, n - 1)
            sl = [slice(None)] * vol.ndim
            sl[axis] = j
            im = to_minus_one_one(clip_to_unit_interval(vol[tuple(sl)], clip))
            if i < n:
                shapes[i] = im.shape
            im = pad_or_center_crop(im, (resolution, resolution), pad_value=-1.0)
            arrs.append(im[..., None])
        return np.stack(arrs).astype(np.float32)

    starts = list(range(0, -(-n // batch_size) * batch_size, batch_size))
    group = max(1, chain_group)
    outs: list[np.ndarray] = []
    for gi in range(0, len(starts), group):
        grp = starts[gi : gi + group]
        stack = torch.from_numpy(np.stack([prep_batch(s) for s in grp])).to(device=device, dtype=dtype)
        gens = [batch_generator(device, seed, s) for s in grp]
        if group > 1:
            sr = pipeline.super_resolve_group(stack, gens, num_steps=num_steps)
        else:
            sr = pipeline.super_resolve(stack[0], gens[0], num_steps=num_steps)[None]
        outs.extend(_crop_on_device(sr, shapes[grp[0]], resolution).float().cpu().numpy())
    sr_all = np.concatenate(outs)[:n]

    vol = restack_slices(sr_all, shapes, axis)
    result = NiftiImage(data=vol.astype(np.float32), affine=img.affine, header=img.header)
    if out_path is not None:
        write_nifti(out_path, result.data, result.affine)
    return result
