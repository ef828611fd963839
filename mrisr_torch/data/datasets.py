"""Slice datasets (port of ``mrisr_tpu/data/datasets.py``); every item is a dict of NHWC numpy arrays.

* :func:`build_patient_index`: a DICOM tree -> ``{pid: {strength: {contrast:
  [slice dicts]}}}``;
* :func:`random_split_lengths` / :func:`patient_split`: the subject-level
  split of ``torch.utils.data.random_split`` with a seeded generator;
* :class:`FastMRISliceDataset`: lazy DICOM slices, center crop, a Lanczos
  resize with PIL's semantics (the port's own, ``ops/resize.py``: no PIL),
  and the synthetic degradation;
* :class:`SlicedPairDataset`: per-slice ``.npz {lr, hr}`` directories;
* :class:`SliceDataset`: BIDS NIfTI pairs with a per-subject cache, slab
  crop, per-modality windows to [-1, 1] and a 512x512 pad or crop.

Batching and shuffling are ``data/loader.py``'s.  The MNIST dataset is not
ported yet.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from mrisr_torch.data.degrade import simulate_low_res_np
from mrisr_torch.data.dicom import (
    TAG_ACQ_MATRIX,
    TAG_FIELD_STRENGTH,
    TAG_INSTANCE_NUMBER,
    TAG_PATIENT_ID,
    TAG_PIXEL_SPACING,
    TAG_SERIES_DESC,
    read_dicom,
)
from mrisr_torch.data.slices import clip_to_unit_interval, crop_slab, pad_or_center_crop, to_minus_one_one
from mrisr_torch.ops.resize import pil_resize_like_np

# ---------------------------------------------------------------------------
# FastMRI DICOM path
# ---------------------------------------------------------------------------


def build_patient_index(root_dir: str | Path, out_json: str | Path | None = None) -> dict:
    """Walk a DICOM tree -> ``{pid: {strength: {contrast: [slice dicts]}}}``; also written to ``out_json``."""
    index: dict = {}
    for dirpath, _, filenames in os.walk(root_dir):
        for fn in sorted(filenames):
            if not fn.lower().endswith((".dcm", ".ima", ".dicom")):
                continue
            path = os.path.join(dirpath, fn)
            try:
                d = read_dicom(path, read_pixels=False)
            except Exception:
                continue
            pid = str(d.get(TAG_PATIENT_ID, "unknown"))
            try:
                strength = f"{float(d.get(TAG_FIELD_STRENGTH)):.1f}T"
            except (TypeError, ValueError):
                strength = "unknown"
            desc = str(d.get(TAG_SERIES_DESC, "")).upper()
            contrast = "T2" if "T2" in desc else ("T1" if "T1" in desc else "other")
            entry = {
                "filename": path,
                "instanceNumber": int(d.get(TAG_INSTANCE_NUMBER) or 0),
                "acquisitionMatrix": d.get(TAG_ACQ_MATRIX),
                "pixelSpacing": d.get(TAG_PIXEL_SPACING),
            }
            index.setdefault(pid, {}).setdefault(strength, {}).setdefault(contrast, []).append(entry)
    if out_json is not None:
        serializable = json.loads(json.dumps(index, default=str))
        Path(out_json).write_text(json.dumps(serializable, indent=2))
    return index


def random_split_lengths(n: int, fractions) -> list[int]:
    """``torch.utils.data.random_split``'s lengths for fractions."""
    lengths = [int(np.floor(f * n)) for f in fractions]
    for i in range(n - sum(lengths)):
        lengths[i % len(lengths)] += 1
    return lengths


def patient_split(items: list, fractions=(0.8, 0.1, 0.1), seed: int = 42) -> dict:
    """Subject-level split, ``random_split`` with ``torch.Generator().manual_seed(seed)``."""
    n = len(items)
    lengths = random_split_lengths(n, fractions)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
    out, offset = {}, 0
    for name, ln in zip(("train", "val", "test"), lengths):
        out[name] = [items[i] for i in perm[offset : offset + ln]]
        offset += ln
    return out


class FastMRISliceDataset:
    """Lazy FastMRI DICOM slices with on-the-fly synthetic degradation."""

    def __init__(
        self,
        json_path: str | Path | None = None,
        index: dict | None = None,
        mode: str = "train",
        target_size: tuple[int, int] = (256, 256),
        contrast_filter: str = "T2",
        strength_filter: str = "3.0T",
        scale_factor: float = 4.0,
        fractions=(0.8, 0.1, 0.1),
        seed: int = 42,
        crop_before_resize: int = 400,
    ):
        if index is None:
            index = json.loads(Path(json_path).read_text())
        self.index = index
        self.target_size = target_size
        self.scale_factor = scale_factor
        self.crop_before_resize = crop_before_resize

        subjects = []
        for pid, strengths in index.items():
            if strength_filter in strengths and contrast_filter in strengths[strength_filter]:
                subjects.append({
                    "subject_id": pid,
                    "strength": strength_filter,
                    "contrast": contrast_filter,
                    "txt": (f"high quality {contrast_filter} brain MRI, "
                            f"{strength_filter} field strength, medical imaging"),
                })
        split = patient_split(subjects, fractions, seed)
        self.subjects = split.get(mode, split["train"])

        self.slice_metadata = []
        for item in self.subjects:
            for s in index[item["subject_id"]][item["strength"]][item["contrast"]]:
                self.slice_metadata.append({
                    "path": s["filename"],
                    "subject_id": item["subject_id"],
                    "txt": item["txt"],
                    "instance": s.get("instanceNumber", 0),
                })

    def __len__(self):
        return len(self.slice_metadata)

    def __getitem__(self, idx: int) -> dict:
        meta = self.slice_metadata[idx]
        arr = read_dicom(meta["path"]).pixel_array
        if arr.max() > arr.min():
            arr = (arr - arr.min()) / (arr.max() - arr.min())
        # center crop, then the Lanczos resize
        c = self.crop_before_resize
        h, w = arr.shape
        th, tw = min(h, c), min(w, c)
        arr = arr[(h - th) // 2 : (h - th) // 2 + th, (w - tw) // 2 : (w - tw) // 2 + tw]
        hr = pil_resize_like_np(arr.astype(np.float32), tuple(self.target_size), filt="lanczos")
        lr = simulate_low_res_np(hr, self.scale_factor)
        return {
            "hr": hr[..., None].astype(np.float32),
            "lr": lr[..., None].astype(np.float32),
            "txt": meta["txt"],
            "subject_id": meta["subject_id"],
            "instance": meta["instance"],
        }


# ---------------------------------------------------------------------------
# Sliced .npz pairs
# ---------------------------------------------------------------------------


class SlicedPairDataset:
    """A directory of per-slice ``.npz {lr, hr}`` files under ``processed_dir/axis``."""

    def __init__(self, processed_dir: str | Path, axis: str = "axial"):
        base = Path(processed_dir) / axis
        self.files = sorted(base.glob("*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no .npz slices under {base}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        with np.load(self.files[idx]) as z:
            lr, hr = z["lr"].astype(np.float32), z["hr"].astype(np.float32)
        return {
            "lr": lr[..., None] if lr.ndim == 2 else lr,
            "hr": hr[..., None] if hr.ndim == 2 else hr,
            "path": str(self.files[idx]),
        }


# ---------------------------------------------------------------------------
# BIDS slice dataset with a per-subject cache
# ---------------------------------------------------------------------------


class SliceDataset:
    """2-D slices of BIDS NIfTI pairs, cached per subject.

    Per subject: read the pair -> optional N4 bias correction of both (``do_n4``) -> optional registration
    (``register_fn``, e.g. ``data/registration.py::register_rigid``) ->
    slab crop [80 : D-30] along the slice axis -> per-modality clip -> [-1,
    1] -> cache npz; per slice a 512x512 pad or crop (pad -1).  ``sub-15``
    is skipped, as in the reference.
    """

    TARGET = (512, 512)

    def __init__(
        self,
        pairs: list[dict],
        slice_axis: int = 2,
        cache_dir: str | Path = "./cache",
        register_fn=None,
        do_n4: bool = False,
        lr_clip=(0, 2000),
        hr_clip=(0, 900),
        skip_subjects=("sub-15",),
        crop_start: int = 80,
        crop_end_margin: int = 30,
    ):
        self.slice_axis = slice_axis
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.register_fn = register_fn
        self.do_n4 = do_n4
        self.lr_clip = lr_clip
        self.hr_clip = hr_clip
        self.crop_start = crop_start
        self.crop_end_margin = crop_end_margin

        self.slice_metadata = []
        for item in pairs:
            sid = item["subject_id"]
            if sid in skip_subjects:
                continue
            hr_arr, lr_arr = self._prepare_subject(item)
            for s in range(hr_arr.shape[self.slice_axis]):
                self.slice_metadata.append(
                    {"hr": hr_arr, "lr": lr_arr, "idx": s, "txt": item.get("txt", ""), "sid": sid})

    def _prepare_subject(self, item: dict):
        from mrisr_torch.data.nifti import read_nifti

        sid = item["subject_id"]
        cache = self.cache_dir / f"{sid}_resampled.npz"
        if cache.exists():
            with np.load(cache) as z:
                return z["hr"], z["lr"]
        hr = read_nifti(item["hr"]).data.astype(np.float32)
        lr = read_nifti(item["lr"]).data.astype(np.float32)
        if self.do_n4:  # on both volumes, before registration (the reference's order), a thread each
            from concurrent.futures import ThreadPoolExecutor

            from mrisr_torch.data.bias_correction import n4_bias_correction

            with ThreadPoolExecutor(2) as pool:  # numpy's and scipy's array loops release the GIL
                hr, lr = pool.map(n4_bias_correction, (hr, lr))
        if self.register_fn is not None and item["hr"] != item["lr"]:
            lr = self.register_fn(fixed=hr, moving=lr)
        hr = crop_slab(hr, self.slice_axis, self.crop_start, self.crop_end_margin)
        lr = crop_slab(lr, self.slice_axis, self.crop_start, self.crop_end_margin)
        hr = to_minus_one_one(clip_to_unit_interval(hr, self.hr_clip))
        lr = to_minus_one_one(clip_to_unit_interval(lr, self.lr_clip))
        np.savez_compressed(cache, hr=hr, lr=lr)
        return hr, lr

    def __len__(self):
        return len(self.slice_metadata)

    def __getitem__(self, idx: int) -> dict:
        m = self.slice_metadata[idx]
        sl = [slice(None)] * 3
        sl[self.slice_axis] = m["idx"]
        hr = pad_or_center_crop(m["hr"][tuple(sl)], self.TARGET)
        lr = pad_or_center_crop(m["lr"][tuple(sl)], self.TARGET)
        return {"hr": hr[..., None], "lr": lr[..., None], "txt": m["txt"], "subject_id": m["sid"]}
