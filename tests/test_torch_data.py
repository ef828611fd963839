"""The port's data path against the JAX package's (and PIL / scipy), on the CPU.

Resize and blur weights and results, the degradation, DICOM files, the
patient index and split, the datasets' items on synthetic DICOM / NIfTI /
npz trees written in ``tmp_path``, the loader's batch indices, and slice
caches written by one package and read by the other.  Inputs come from numpy
with fixed seeds; each tolerance is stated where it is checked.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrisr_tpu.data import datasets as j_ds
from mrisr_tpu.data import degrade as j_degrade
from mrisr_tpu.data import dicom as j_dicom
from mrisr_tpu.data import loader as j_loader
from mrisr_tpu.data import slicecache as j_cache
from mrisr_tpu.ops import resize as j_resize
from mrisr_torch.data import datasets as t_ds
from mrisr_torch.data import degrade as t_degrade
from mrisr_torch.data import dicom as t_dicom
from mrisr_torch.data import loader as t_loader
from mrisr_torch.data import slicecache as t_cache
from mrisr_torch.data.nifti import write_nifti
from mrisr_torch.ops import resize as t_resize
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _u(*shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/resize.py
# ---------------------------------------------------------------------------

WEIGHT_CASES = [(64, 16, "bicubic_torch", False, "clamp"), (16, 64, "bicubic_torch", False, "clamp"),
                (40, 24, "lanczos", True, "shrink"), (24, 40, "bicubic", True, "shrink"),
                (30, 17, "bilinear", True, "clamp"), (9, 20, "nearest", False, "clamp")]


@pytest.mark.parametrize("case", WEIGHT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_resize_weights_and_results_match_jax(case):
    """The weight matrices are the reference's bit for bit; the resize of ``[2, 3, H, W]`` within 1e-6."""
    n_in, n_out, kernel, antialias, edge = case
    w = t_resize._resize_weights(n_in, n_out, kernel, antialias, edge)
    np.testing.assert_array_equal(w, j_resize._resize_weights(n_in, n_out, kernel, antialias, edge))
    x = _u(2, 3, n_in, n_in + 3, seed=1)
    out_hw = (n_out, n_out + 2)
    want = np.asarray(j_resize.resize2d(jnp.asarray(x), out_hw, kernel, antialias, edge))
    got = t_resize.resize2d(torch.from_numpy(x), out_hw, kernel, antialias, edge)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_resize.resize2d_np(x, out_hw, kernel, antialias, edge), want, atol=1e-6, rtol=1e-6)


def test_interpolate_pil_blur_and_shuffle_match_jax_torch_pil_and_scipy():
    """``interpolate_like_torch`` against JAX's and ``F.interpolate`` (interior, where the edge handling
    agrees); ``pil_resize_like`` against JAX's and PIL's float resize; ``gaussian_blur`` against JAX's and
    ``scipy.ndimage.gaussian_filter``; pixel (un)shuffle against JAX's and torch's.  1e-5 unless stated."""
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    x = _u(2, 1, 32, 24, seed=2)
    for mode in ("bicubic", "bilinear", "nearest"):
        got = t_resize.interpolate_like_torch(torch.from_numpy(x), (64, 48), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_resize.interpolate_like_torch(jnp.asarray(x), (64, 48),
                                                                                            mode)), atol=1e-5)
        ref = F.interpolate(torch.from_numpy(x), (64, 48), mode=mode,
                            **({} if mode == "nearest" else {"align_corners": False}))
        np.testing.assert_allclose(got[..., 4:-4, 4:-4].numpy(), ref[..., 4:-4, 4:-4].numpy(), atol=1e-5)
    img = _u(37, 29, seed=3)
    for filt, pil_filt, size in (("lanczos", Image.LANCZOS, (16, 12)), ("bicubic", Image.BICUBIC, (50, 41)),
                                 ("bicubic", Image.BICUBIC, (9, 7))):
        # The numpy form is PIL's (its window and order of passes): within 2e-7 of PIL's float resize.
        got = t_resize.pil_resize_like_np(img, size, filt)
        pil = np.asarray(Image.fromarray(img).resize((size[1], size[0]), resample=pil_filt))
        np.testing.assert_allclose(got, pil, atol=2e-7)
        # The tensor form is the reference's (its window drops PIL's last tap at some non-integer scales).
        np.testing.assert_allclose(t_resize.pil_resize_like(torch.from_numpy(img), size, filt).numpy(),
                                   np.asarray(j_resize.pil_resize_like(jnp.asarray(img), size, filt)), atol=1e-6)
    sq = _u(64, 48, seed=10)  # at integer scales the two windows hold the same taps
    np.testing.assert_allclose(t_resize.pil_resize_like_np(sq, (16, 12), "lanczos"),
                               np.asarray(j_resize.pil_resize_like(jnp.asarray(sq), (16, 12), "lanczos")), atol=1e-6)
    for sigma in (0.7, 2.0):
        got = t_resize.gaussian_blur(torch.from_numpy(img), sigma).numpy()
        np.testing.assert_allclose(got, np.asarray(j_resize.gaussian_blur(jnp.asarray(img), sigma)), atol=1e-6)
        np.testing.assert_allclose(got, gaussian_filter(img, sigma), atol=1e-6)
    y = _u(2, 12, 5, 6, seed=4)
    shuffled = t_resize.pixel_shuffle(torch.from_numpy(y), 2)
    assert torch.equal(shuffled, F.pixel_shuffle(torch.from_numpy(y), 2))
    np.testing.assert_array_equal(shuffled.numpy(), np.asarray(j_resize.pixel_shuffle(jnp.asarray(y), 2)))
    assert torch.equal(t_resize.pixel_unshuffle(shuffled, 2), torch.from_numpy(y))


# ---------------------------------------------------------------------------
# data/degrade.py
# ---------------------------------------------------------------------------


def test_degradation_matches_jax_and_the_pil_reference():
    """``simulate_low_res`` (tensors, a batch) against JAX's within 1e-5; ``simulate_low_res_np`` (no PIL)
    against the reference's PIL + scipy form within 1e-6."""
    hr = _u(2, 48, 40, seed=5)
    want = np.asarray(j_degrade.simulate_low_res(jnp.asarray(hr), 4.0))
    np.testing.assert_allclose(t_degrade.simulate_low_res(torch.from_numpy(hr), 4.0).numpy(), want, atol=1e-5)
    for scale in (2.0, 4.0):
        got = t_degrade.simulate_low_res_np(hr[0], scale)
        assert got.dtype == np.float32 and got.shape == hr[0].shape
        np.testing.assert_allclose(got, j_degrade.simulate_low_res_np(hr[0], scale), atol=1e-6)


# ---------------------------------------------------------------------------
# DICOM, the patient index and the datasets
# ---------------------------------------------------------------------------


def _dicom_tree(root, writer, n_patients=6, slices=3, seed=6):
    rng = np.random.default_rng(seed)
    for p in range(n_patients):
        for s in range(slices):
            d = root / f"p{p:02d}"
            d.mkdir(parents=True, exist_ok=True)
            px = rng.integers(0, 4000, (44, 52)).astype(np.uint16)
            strength = "3.0" if p % 3 else "1.5"
            writer(d / f"s{s}.dcm", px, patient_id=f"p{p:02d}", field_strength=strength,
                   series_desc="AX T2 FLAIR" if p != 4 else "AX T1", instance_number=s + 1)
    return root


def test_dicom_files_read_across_packages_and_the_index_and_split_match(tmp_path):
    """A file written by either package reads the same in both; the patient index of a DICOM tree and
    ``patient_split`` are the reference's (the split is torch's seeded ``randperm``)."""
    px = np.random.default_rng(7).integers(0, 60000, (20, 24)).astype(np.uint16)
    for writer, reader in ((t_dicom.write_dicom_minimal, j_dicom.read_dicom),
                           (j_dicom.write_dicom_minimal, t_dicom.read_dicom)):
        path = tmp_path / f"{writer.__module__}.dcm"
        writer(path, px, patient_id="p9", field_strength="3.0", series_desc="AX T2", instance_number=4)
        d = reader(path)
        np.testing.assert_array_equal(d.pixel_array, px.astype(np.float32))
        assert d.get(t_dicom.TAG_PATIENT_ID) == "p9" and int(d.get(t_dicom.TAG_INSTANCE_NUMBER)) == 4
    root = _dicom_tree(tmp_path / "tree", t_dicom.write_dicom_minimal)
    index = t_ds.build_patient_index(root, tmp_path / "index.json")
    assert index == j_ds.build_patient_index(root)
    assert json.loads((tmp_path / "index.json").read_text()) == json.loads(json.dumps(index, default=str))
    items = list(range(23))
    for seed in (0, 42):
        assert t_ds.patient_split(items, seed=seed) == j_ds.patient_split(items, seed=seed)
    assert t_ds.random_split_lengths(23, (0.8, 0.1, 0.1)) == j_ds.random_split_lengths(23, (0.8, 0.1, 0.1))


def test_fastmri_dataset_items_match_jax(tmp_path):
    """The same slices, keys and metadata for a seed; HR (Lanczos without PIL) and LR within 1e-6 of the
    reference's (PIL's) items."""
    root = _dicom_tree(tmp_path / "tree", t_dicom.write_dicom_minimal)
    index = t_ds.build_patient_index(root)
    kw = dict(index=index, target_size=(32, 40), crop_before_resize=40, seed=3)
    got, want = t_ds.FastMRISliceDataset(mode="train", **kw), j_ds.FastMRISliceDataset(mode="train", **kw)
    assert len(got) == len(want) > 0 and got.slice_metadata == want.slice_metadata
    assert len(t_ds.FastMRISliceDataset(mode="val", **kw)) == len(j_ds.FastMRISliceDataset(mode="val", **kw))
    for i in (0, len(got) - 1):
        a, b = got[i], want[i]
        assert set(a) == set(b) and a["hr"].shape == (32, 40, 1) and a["hr"].dtype == np.float32
        assert (a["txt"], a["subject_id"], a["instance"]) == (b["txt"], b["subject_id"], b["instance"])
        np.testing.assert_allclose(a["hr"], b["hr"], atol=1e-6)
        np.testing.assert_allclose(a["lr"], b["lr"], atol=1e-6)


def test_sliced_pair_and_bids_slice_datasets_match_jax(tmp_path):
    """Per-slice npz pairs: equal items.  BIDS NIfTI pairs (written by the port, read by each package's
    reader): equal slice metadata and items, and the subject cache reads back the same."""
    rng = np.random.default_rng(8)
    (tmp_path / "npz" / "axial").mkdir(parents=True)
    for i in range(3):
        np.savez_compressed(tmp_path / "npz" / "axial" / f"s{i}.npz", lr=rng.random((8, 6), np.float32),
                            hr=rng.random((8, 6), np.float32))
    got, want = t_ds.SlicedPairDataset(tmp_path / "npz"), j_ds.SlicedPairDataset(tmp_path / "npz")
    assert len(got) == len(want) == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i]["lr"], want[i]["lr"])
        np.testing.assert_array_equal(got[i]["hr"], want[i]["hr"])
    pairs = []
    for sid in ("sub-01", "sub-15", "sub-02"):
        hr_vol = (rng.random((20, 18, 120)) * 1200).astype(np.float32)
        lr_vol = (rng.random((20, 18, 120)) * 2500).astype(np.float32)
        write_nifti(tmp_path / f"{sid}_hr.nii", hr_vol)
        write_nifti(tmp_path / f"{sid}_lr.nii", lr_vol)
        pairs.append({"subject_id": sid, "hr": str(tmp_path / f"{sid}_hr.nii"),
                      "lr": str(tmp_path / f"{sid}_lr.nii"), "txt": sid})
    for rep in range(2):  # the second pass reads each package's subject cache
        got = t_ds.SliceDataset(pairs, cache_dir=tmp_path / "t_cache")
        want = j_ds.SliceDataset(pairs, cache_dir=tmp_path / "j_cache")
        assert len(got) == len(want) == 2 * (120 - 80 - 30)
        for i in (0, 7, len(got) - 1):
            a, b = got[i], want[i]
            assert a["hr"].shape == (512, 512, 1) and (a["txt"], a["subject_id"]) == (b["txt"], b["subject_id"])
            np.testing.assert_allclose(a["hr"], b["hr"], atol=1e-6)
            np.testing.assert_allclose(a["lr"], b["lr"], atol=1e-6)
    with pytest.raises(NotImplementedError):
        t_ds.SliceDataset(pairs, cache_dir=tmp_path / "n4", do_n4=True)


# ---------------------------------------------------------------------------
# data/loader.py and data/slicecache.py
# ---------------------------------------------------------------------------


class _Indexed:
    """Items that name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 2, 1), i, np.float32), "name": f"item{i}"}


def test_loader_batches_match_jax_and_resume_from_a_batch_number():
    """Two epochs of shuffled batches for a seed equal the reference loader's; ``batches(start)`` continues
    the sequence a loader started at 0 gives; an abandoned iteration stops its thread."""
    ds = _Indexed(23)
    for shuffle, drop_last in ((True, True), (False, False)):
        t = t_loader.Loader(ds, batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last)
        j = j_loader.Loader(ds, batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last)
        assert len(t) == len(j)
        for _ in range(2):
            got, want = list(t), list(j)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["x"], b["x"])
                assert a["name"] == b["name"]
    whole = t_loader.Loader(ds, batch_size=4, shuffle=True, seed=5).batches()
    seq = [next(whole)["x"][:, 0, 0, 0].tolist() for _ in range(13)]
    whole.close()
    for start in (0, 3, 5, 11):
        part = t_loader.Loader(ds, batch_size=4, shuffle=True, seed=5).batches(start)
        assert [next(part)["x"][:, 0, 0, 0].tolist() for _ in range(13 - start)] == seq[start:]
        part.close()
    loader = t_loader.Loader(ds, batch_size=2, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()
    assert loader.made >= 1 and loader.make_seconds > 0


def test_slice_caches_read_across_packages(tmp_path):
    """A cache written by either package (``build_cache_from_dataset``) reads back equal in both, per item
    and through the vectorised gather, and the loader takes the gather path."""
    rng = np.random.default_rng(9)
    items = [{"lr": rng.random((12, 10, 1), np.float32), "hr": rng.random((12, 10, 1), np.float32)}
             for _ in range(5)]
    for build, name in ((t_cache.build_cache_from_dataset, "port"), (j_cache.build_cache_from_dataset, "jax")):
        path = tmp_path / f"{name}.slc"
        build(items, path).close()
        for ds in (t_cache.SliceCacheDataset(path), j_cache.SliceCacheDataset(path)):
            assert len(ds) == 5
            np.testing.assert_array_equal(ds[3]["hr"], items[3]["hr"])
            batch = ds.get_batch([4, 0, 2])
            np.testing.assert_array_equal(batch["lr"], np.stack([items[i]["lr"] for i in (4, 0, 2)]))
        loaded = list(t_loader.Loader(t_cache.SliceCacheDataset(path), batch_size=5))
        np.testing.assert_array_equal(loaded[0]["hr"], np.stack([it["hr"] for it in items]))
    assert t_cache.library_path().exists()
    with pytest.raises(OSError):
        t_cache.SliceCache.open(tmp_path / "missing.slc")
