"""Per-slice ``.npz`` pairs -> 8-bit PNGs and an HF-style ``metadata.jsonl`` (port of
``mrisr_tpu/data/export.py``).

Each array is scaled to uint8 by its own min and max and written to
``hr_images/`` and ``lr_images/`` by the port's PNG writer (no PIL); each pair
gets a ``metadata.jsonl`` row with the ``"file_name"`` key of the HF
``imagefolder`` convention, as the reference's.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mrisr_torch.data.png import write_png_gray


def normalize_to_uint8(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 3 and arr.shape[0] == 1:
        arr = arr[0]
    lo, hi = float(arr.min()), float(arr.max())
    arr = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
    return (arr * 255).astype(np.uint8)


def export_png_dataset(source_dir: str | Path, dest_dir: str | Path, caption: str = "high quality mri scan") -> int:
    """Write every ``source_dir/*.npz`` pair as PNGs under ``dest_dir``; returns the pairs written (a file
    that fails to read or write is reported and skipped)."""
    source_dir, dest_dir = Path(source_dir), Path(dest_dir)
    (dest_dir / "hr_images").mkdir(parents=True, exist_ok=True)
    (dest_dir / "lr_images").mkdir(parents=True, exist_ok=True)
    count = 0
    with open(dest_dir / "metadata.jsonl", "w") as meta:
        for npz_path in sorted(source_dir.glob("*.npz")):
            try:
                with np.load(npz_path) as z:
                    hr, lr = z["hr"], z["lr"]
                hr_rel = f"hr_images/{npz_path.stem}.png"
                lr_rel = f"lr_images/{npz_path.stem}.png"
                write_png_gray(dest_dir / hr_rel, normalize_to_uint8(hr))
                write_png_gray(dest_dir / lr_rel, normalize_to_uint8(lr))
                meta.write(json.dumps({"file_name": hr_rel, "conditioning_image": lr_rel, "text": caption}) + "\n")
                count += 1
            except Exception as e:  # skip a corrupt entry, keep going (the reference's behaviour)
                print(f"skipping {npz_path}: {e}")
    return count
