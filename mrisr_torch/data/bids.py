"""BIDS tree scanners for paired low- and high-field MRI (port of ``mrisr_tpu/data/bids.py``).

* :func:`get_data_dicts`: each subject's 64 mT T1w under ``64mT data/`` paired
  with the 3 T ``sub-XXXX_acq-highres_T1w.nii.gz`` under ``3T data/``;
* :func:`dataset_stats`: subject, session, run and acquisition counts of both
  trees, their overlap and the number of pairs (the ``stats`` command);
* :func:`get_data_dicts_artificial`: a 3 T-only scan, where ``lr`` is
  ``hr``'s path and the degradation is left to the dataset.
"""
from __future__ import annotations

from pathlib import Path


def get_data_dicts(data_dir: str | Path) -> list[dict]:
    data_dir = Path(data_dir)
    lr_dir = data_dir / "64mT data"
    hr_dir = data_dir / "3T data"
    pairs = []
    for subject_dir in sorted(lr_dir.glob("sub-*")):
        subject_id = subject_dir.name
        sess_dirs = sorted(subject_dir.glob("ses-*"))
        if not sess_dirs:
            continue
        lr_files = sorted((sess_dirs[0] / "anat").glob("*T1w.nii.gz"))
        if not lr_files:
            continue
        hr_path = hr_dir / subject_id / "anat" / f"{subject_id}_acq-highres_T1w.nii.gz"
        if hr_path.exists():
            pairs.append({"lr": str(lr_files[0]), "hr": str(hr_path), "subject_id": subject_id})
    return pairs


def _entities(scans: list[str], prefix: str) -> list[str]:
    """The sorted distinct values of one BIDS entity (``acq-``, ``run-``) in the scans' file names."""
    return sorted({part.split("-", 1)[1] for f in scans for part in Path(f).name.split("_")
                   if part.startswith(prefix)})


def _scan_tree(root: Path) -> dict:
    subjects: dict[str, dict] = {}
    for sub in sorted(root.glob("sub-*")):
        sessions = sorted(d.name for d in sub.glob("ses-*"))
        scans = sorted(str(f.relative_to(sub)) for f in sub.rglob("*.nii*"))
        subjects[sub.name] = {"n_sessions": len(sessions), "n_scans": len(scans),
                              "acquisitions": _entities(scans, "acq-"), "runs": _entities(scans, "run-")}
    return subjects


def dataset_stats(data_dir: str | Path) -> dict:
    """Subject counts per field strength, their overlap, session / run / acquisition lists per subject, and
    the number of paired scans."""
    data_dir = Path(data_dir)
    lf = _scan_tree(data_dir / "64mT data")
    hf = _scan_tree(data_dir / "3T data")
    return {
        "low_field": {"n_subjects": len(lf), "subjects": lf},
        "high_field": {"n_subjects": len(hf), "subjects": hf},
        "overlap": {
            "n_subjects_in_both": len(set(lf) & set(hf)),
            "subjects": sorted(set(lf) & set(hf)),
            "only_low_field": sorted(set(lf) - set(hf)),
            "only_high_field": sorted(set(hf) - set(lf)),
        },
        "paired_scans": len(get_data_dicts(data_dir)),
    }


def get_data_dicts_artificial(data_dir: str | Path, modality: str = "T2w") -> list[dict]:
    base = Path(data_dir) / "rawdata_BIDS_3T"
    out = []
    for subject_dir in sorted(base.glob("sub-*")):
        files = sorted((subject_dir / "anat").glob(f"*{modality}*.nii*"))
        if not files:
            continue
        prompt = (f"high quality MRI scan, {modality} brain slice, 3T field strength, "
                  "precise anatomical details, sharp focus, medical imaging")
        out.append({"lr": str(files[0]), "hr": str(files[0]), "txt": prompt, "subject_id": subject_dir.name})
    return out
