"""Visual dataset report: PNG montages and a stats JSON (port of ``mrisr_tpu/data/report.py``).

For each paired subject an ``LR | HR`` montage at three depths along the
chosen axis (each panel scaled by its 1st and 99th percentiles, padded to the
largest panel), written by the port's PNG writer; beside them
``stats.json``, the ``stats`` command's report with the montages' paths.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mrisr_torch.data.bids import dataset_stats, get_data_dicts
from mrisr_torch.data.nifti import read_nifti, to_ras
from mrisr_torch.data.png import write_png_gray


def _norm_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = np.percentile(img, (1, 99))
    img = np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)
    return (img * 255).astype(np.uint8)


def _slices_at(vol: np.ndarray, axis: int, fracs=(0.25, 0.5, 0.75)) -> list[np.ndarray]:
    out = []
    for f in fracs:
        sl = [slice(None)] * vol.ndim
        sl[axis] = int(vol.shape[axis] * f)
        out.append(np.asarray(vol[tuple(sl)]))
    return out


def _montage(rows: list[list[np.ndarray]]) -> np.ndarray:
    """Rows of panels -> one uint8 image, each panel on a canvas of the largest panel's size."""
    h = max(p.shape[0] for r in rows for p in r)
    w = max(p.shape[1] for r in rows for p in r)
    grid = []
    for r in rows:
        padded = []
        for p in r:
            canvas = np.zeros((h, w), np.uint8)
            canvas[: p.shape[0], : p.shape[1]] = _norm_u8(p)
            padded.append(canvas)
        grid.append(np.hstack(padded))
    return np.vstack(grid)


def visual_report(data_dir: str | Path, out_dir: str | Path, axis: int = 2, max_subjects: int | None = None) -> dict:
    """Write each pair's ``{subject}_lr_hr.png`` montage and ``stats.json``; returns the stats."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pairs = get_data_dicts(data_dir)
    if max_subjects:
        pairs = pairs[:max_subjects]
    written = []
    for pair in pairs:
        lr = to_ras(read_nifti(pair["lr"])).data
        hr = to_ras(read_nifti(pair["hr"])).data
        path = out / f"{pair['subject_id']}_lr_hr.png"
        write_png_gray(path, _montage([_slices_at(lr, axis), _slices_at(hr, axis)]))
        written.append(str(path))
    stats = dataset_stats(data_dir)
    stats["montages"] = written
    (out / "stats.json").write_text(json.dumps(stats, indent=2, sort_keys=True))
    return stats
