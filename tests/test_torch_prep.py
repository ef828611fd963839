"""Data preparation and scoring on the CPU, held to the JAX package (and PIL) on the same inputs: the PNG
reader and writer, ``export-png``, ``evaluate`` (``MRIEvaluator``), ``stats``, ``build-index``, ``report``,
N4 bias correction, the linear 3-D resize, rigid registration, ``preprocess-slices`` and
``SliceDataset(do_n4=True, register_fn=...)``.  Inputs are made from numpy seeds in ``tmp_path``; each
tolerance is stated where it is checked.
"""
from __future__ import annotations

import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mrisr_tpu import cli as j_cli
from mrisr_tpu.data import bias_correction as j_n4
from mrisr_tpu.data import datasets as j_ds
from mrisr_tpu.data import registration as j_reg
from mrisr_tpu.data import report as j_report
from mrisr_tpu.eval.metrics import MRIEvaluator as JEvaluator
from mrisr_torch import cli as t_cli
from mrisr_torch.data import bias_correction as t_n4
from mrisr_torch.data import datasets as t_ds
from mrisr_torch.data import png as t_png
from mrisr_torch.data import registration as t_reg
from mrisr_torch.data.dicom import write_dicom_minimal
from mrisr_torch.data.nifti import write_nifti
from mrisr_torch.eval.metrics import MRIEvaluator as TEvaluator
from mrisr_torch.ops import resize as t_resize
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _pil_gray(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_MODES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}


def _filtered(rows: np.ndarray, bpp: int, kind: int) -> bytes:
    """``rows`` ``[H, W * bpp]`` uint8 PNG-filtered with filter ``kind`` on every row (the encoder's side)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(mode: str, px: np.ndarray, kind: int, palette: np.ndarray | None = None, interlace: int = 0) -> bytes:
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _MODES[mode], 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += chunk(b"IDAT", zlib.compress(_filtered(px.reshape(h, w * bpp), bpp, kind)))
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


@pytest.mark.parametrize("mode", list(_MODES))
def test_png_reader_equals_pil_convert_l(mode, tmp_path):
    """Each color type under each of the five row filters (one file each, written by the test's encoder) and as
    PIL saves it: ``read_png_gray`` equals PIL's ``convert("L")`` exactly."""
    rng = np.random.default_rng(_MODES[mode])
    bpp = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    px = rng.integers(0, 256, (13, 17, bpp), dtype=np.uint8)
    palette = None
    if mode == "P":
        palette = rng.integers(0, 256, (40, 3))
        px = rng.integers(0, 40, (13, 17, 1), dtype=np.uint8)
    px = px[..., 0] if bpp == 1 else px
    for kind in range(5):
        path = tmp_path / f"{mode}_{kind}.png"
        path.write_bytes(_png(mode, px, kind, palette))
        np.testing.assert_array_equal(t_png.read_png_gray(path), _pil_gray(path), err_msg=f"filter {kind}")
    im = Image.fromarray(px, mode)
    if mode == "P":
        im.putpalette(palette.astype(np.uint8).reshape(-1).tolist())
    im.save(tmp_path / "pil.png")
    np.testing.assert_array_equal(t_png.read_png_gray(tmp_path / "pil.png"), _pil_gray(tmp_path / "pil.png"))


def test_png_writer_and_errors(tmp_path):
    """PIL reads the writer's PNG back exactly; a 16-bit or interlaced PNG and a non-PNG raise; a JPEG is read
    through PIL."""
    px = np.random.default_rng(1).integers(0, 256, (9, 14), dtype=np.uint8)
    t_png.write_png_gray(tmp_path / "w.png", px)
    np.testing.assert_array_equal(_pil_gray(tmp_path / "w.png"), px)
    np.testing.assert_array_equal(t_png.read_gray(tmp_path / "w.png"), px)
    Image.fromarray(px.astype(np.uint16) * 200).save(tmp_path / "16.png")
    with pytest.raises(ValueError, match="8-bit"):
        t_png.read_png_gray(tmp_path / "16.png")
    (tmp_path / "i.png").write_bytes(_png("L", px, 0, interlace=1))  # the header says Adam7
    with pytest.raises(ValueError, match="interlace"):
        t_png.read_png_gray(tmp_path / "i.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        t_png.read_png_gray(tmp_path / "x.png")
    Image.fromarray(px).save(tmp_path / "j.jpg")
    np.testing.assert_array_equal(t_png.read_gray(tmp_path / "j.jpg"), _pil_gray(tmp_path / "j.jpg"))


# ---------------------------------------------------------------------------
# export-png and evaluate
# ---------------------------------------------------------------------------


def test_export_png_equals_jax(tmp_path):
    """``export-png`` in both packages over ``.npz`` pairs ([H, W], [1, H, W], a flat one) and a corrupt file:
    PIL decodes the port's PNGs to JAX's pixels, and ``metadata.jsonl`` is byte-equal."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(2)
    np.savez(src / "a.npz", hr=rng.normal(0, 1, (12, 10)), lr=rng.normal(0, 1, (1, 12, 10)).astype(np.float32))
    np.savez(src / "b.npz", hr=np.full((8, 8), 3.0, np.float32), lr=rng.random((8, 8)).astype(np.float32))
    (src / "c.npz").write_bytes(b"corrupt")
    res = t_cli.run(["export-png", "--source", str(src), "--dest", str(tmp_path / "t")])
    assert j_cli.main(["export-png", "--source", str(src), "--dest", str(tmp_path / "j")]) == 0
    assert res["pairs"] == 2
    assert (tmp_path / "t" / "metadata.jsonl").read_bytes() == (tmp_path / "j" / "metadata.jsonl").read_bytes()
    for rel in ("hr_images/a.png", "lr_images/a.png", "hr_images/b.png", "lr_images/b.png"):
        np.testing.assert_array_equal(_pil_gray(tmp_path / "t" / rel), _pil_gray(tmp_path / "j" / rel), err_msg=rel)


def _folders(tmp_path, case: str):
    """gen / gt folders of 24x24 images: equal pairs, different pairs (gray, RGB and a JPEG), or different
    pairs and one unreadable file."""
    rng = np.random.default_rng(4)
    gen, gt = tmp_path / f"{case}_gen", tmp_path / f"{case}_gt"
    gen.mkdir()
    gt.mkdir()
    for i in range(4):
        truth = rng.integers(0, 256, (24, 24), dtype=np.uint8)
        Image.fromarray(truth).save(gt / f"s{i}.png")
        if case == "equal":
            Image.fromarray(truth).save(gen / f"s{i}.png")
            continue
        noisy = np.clip(truth + rng.normal(0, 20, truth.shape), 0, 255).astype(np.uint8)
        if i == 1:
            Image.fromarray(np.stack([noisy, truth, noisy // 2], -1)).save(gen / f"s{i}.png")
        else:
            Image.fromarray(noisy).save(gen / f"s{i}.png")
    if case != "equal":
        Image.fromarray(rng.integers(0, 256, (24, 24), dtype=np.uint8)).save(gen / "t.jpg")
        Image.fromarray(rng.integers(0, 256, (24, 24), dtype=np.uint8)).save(gt / "t.jpg")
    if case == "unreadable":
        (gen / "s2.png").write_bytes(b"\x89PNG truncated")
    return gen, gt


@pytest.mark.parametrize("case", ["equal", "different", "unreadable"])
def test_evaluate_equals_jax(case, tmp_path):
    """``evaluate --cpu`` against JAX's ``MRIEvaluator``: equal ``count`` and metrics within 1e-5 relative
    (infinite PSNR on equal pairs in both)."""
    gen, gt = _folders(tmp_path, case)
    got = t_cli.run(["evaluate", "--cpu", "--gen", str(gen), "--gt", str(gt)])["results"]
    want = JEvaluator(verbose=False).evaluate_folders(str(gen), str(gt))
    assert got["count"] == want["count"] == {"equal": 4, "different": 5, "unreadable": 4}[case]
    for k in ("PSNR", "SSIM", "HFEN", "NMSE"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12, err_msg=k)


def test_evaluate_resumes_from_its_state_file(tmp_path):
    """Two pairs evaluated with a state file, then the rest added and evaluated from that file: equal to an
    uninterrupted run (exactly) and to JAX's resumed run (1e-5 relative); with every pair done, a third call
    returns the same."""
    gen, gt = _folders(tmp_path, "different")
    part_gen, part_gt = tmp_path / "pg", tmp_path / "pt"
    part_gen.mkdir()
    part_gt.mkdir()
    files = sorted(p.name for p in gen.iterdir())
    for name in files[:2]:
        (part_gen / name).write_bytes((gen / name).read_bytes())
        (part_gt / name).write_bytes((gt / name).read_bytes())
    ev = TEvaluator(verbose=False, device="cpu")
    whole = ev.evaluate_folders(str(gen), str(gt))
    for name, ev_, state in (("t", ev, tmp_path / "t.json"), ("j", JEvaluator(verbose=False), tmp_path / "j.json")):
        first = ev_.evaluate_folders(str(part_gen), str(part_gt), state_file=str(state))
        assert first["count"] == 2
        for p in gen.iterdir():
            (part_gen / p.name).write_bytes(p.read_bytes())
        for p in gt.iterdir():
            (part_gt / p.name).write_bytes(p.read_bytes())
        resumed = ev_.evaluate_folders(str(part_gen), str(part_gt), state_file=str(state))
        if name == "t":
            assert resumed == whole
            assert ev_.evaluate_folders(str(part_gen), str(part_gt), state_file=str(state)) == whole
        else:
            assert resumed["count"] == whole["count"]
            for k in ("PSNR", "SSIM", "HFEN", "NMSE"):
                np.testing.assert_allclose(whole[k], resumed[k], rtol=1e-5, err_msg=k)
        for p in list(part_gen.iterdir()) + list(part_gt.iterdir()):
            if p.name not in files[:2]:
                p.unlink()


# ---------------------------------------------------------------------------
# BIDS trees: stats, report; DICOM: build-index
# ---------------------------------------------------------------------------


def _head(shape, seed, scale=800.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    blob = np.exp(-((xx - 0.1) ** 2 / 0.3 + (yy + 0.1) ** 2 / 0.4 + zz**2 / 0.5))
    return (scale * blob * ((xx**2 + yy**2 + zz**2) < 0.9) + rng.normal(0, 5, shape)).astype(np.float32)


def _bids(root, subjects=("sub-0001", "sub-0002"), lr_shape=(9, 11, 6), hr_shape=(12, 10, 8)):
    """``64mT data/sub-*/ses-*/anat/*T1w.nii.gz`` and ``3T data/sub-*/anat/*_acq-highres_T1w.nii.gz`` (plus
    a low-field-only and a high-field-only subject, a second session and run entities for ``stats``)."""
    flip = np.diag([-1.0, 1.0, 2.0, 1.0])
    for i, sid in enumerate(subjects):
        anat = root / "64mT data" / sid / "ses-1" / "anat"
        anat.mkdir(parents=True)
        write_nifti(anat / f"{sid}_ses-1_run-1_T1w.nii.gz", _head(lr_shape, 10 + i), flip)
        (root / "64mT data" / sid / "ses-2").mkdir()
        hr = root / "3T data" / sid / "anat"
        hr.mkdir(parents=True)
        write_nifti(hr / f"{sid}_acq-highres_T1w.nii.gz", _head(hr_shape, 20 + i, 600.0), np.eye(4))
    only_lf = root / "64mT data" / "sub-0009" / "ses-1" / "anat"
    only_lf.mkdir(parents=True)
    write_nifti(only_lf / "sub-0009_ses-1_acq-fast_T1w.nii.gz", _head((4, 4, 4), 3), np.eye(4))
    only_hf = root / "3T data" / "sub-0010" / "anat"
    only_hf.mkdir(parents=True)
    write_nifti(only_hf / "sub-0010_run-2_T2w.nii.gz", _head((4, 4, 4), 4), np.eye(4))
    return root


def test_stats_equals_jax(tmp_path):
    """``stats`` writes JAX's JSON byte for byte; the pair scanners (``get_data_dicts`` and the 3 T-only
    ``get_data_dicts_artificial``) list what JAX's do."""
    from mrisr_tpu.data import bids as j_bids
    from mrisr_torch.data import bids as t_bids

    bids = _bids(tmp_path / "bids")
    for sid, names in (("sub-01", ("sub-01_T2w.nii.gz", "sub-01_T1w.nii.gz")), ("sub-02", ("sub-02_T1w.nii",)),
                       ("sub-03", ("sub-03_run-1_T2w.nii", "sub-03_run-2_T2w.nii.gz"))):
        (bids / "rawdata_BIDS_3T" / sid / "anat").mkdir(parents=True)
        for name in names:
            (bids / "rawdata_BIDS_3T" / sid / "anat" / name).write_bytes(b"")
    for modality in ("T2w", "T1w"):
        assert t_bids.get_data_dicts_artificial(bids, modality) == j_bids.get_data_dicts_artificial(bids, modality)
    assert t_bids.get_data_dicts(bids) == j_bids.get_data_dicts(bids)
    res = t_cli.run(["stats", "--data-dir", str(bids), "--out", str(tmp_path / "t.json")])
    assert j_cli.main(["stats", "--data-dir", str(bids), "--out", str(tmp_path / "j.json")]) == 0
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert res["stats"]["paired_scans"] == 2 and res["stats"]["overlap"]["only_low_field"] == ["sub-0009"]


def test_report_equals_jax(tmp_path):
    """Montages (the port's PNG writer, PIL decoding JAX's) pixel for pixel, and ``stats.json`` byte-equal
    (both written to the same directory in turn)."""
    bids = _bids(tmp_path / "bids")
    out = tmp_path / "report"
    j_report.visual_report(bids, out, axis=2)
    want = {p.name: (_pil_gray(p) if p.suffix == ".png" else p.read_bytes()) for p in out.iterdir()}
    res = t_cli.run(["report", "--data-dir", str(bids), "--out", str(out)])
    got = {p.name: (_pil_gray(p) if p.suffix == ".png" else p.read_bytes()) for p in out.iterdir()}
    assert sorted(got) == sorted(want) == ["stats.json", "sub-0001_lr_hr.png", "sub-0002_lr_hr.png"]
    assert got["stats.json"] == want["stats.json"] and len(res["stats"]["montages"]) == 2
    for name in ("sub-0001_lr_hr.png", "sub-0002_lr_hr.png"):
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(t_png.read_png_gray(out / name), want[name])


def test_build_index_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    for pid, strength in (("p1", "3.0"), ("p2", "1.5")):
        for desc in ("AX T2", "T1 SAG"):
            d = tmp_path / "dicom" / pid / desc.replace(" ", "_")
            d.mkdir(parents=True)
            for k in range(3):
                write_dicom_minimal(d / f"{k}.dcm", rng.integers(0, 4000, (6, 5)), patient_id=pid,
                                    field_strength=strength, series_desc=desc, instance_number=k + 1)
    (tmp_path / "dicom" / "p1" / "junk.dcm").write_bytes(b"junk")
    res = t_cli.run(["build-index", "--root", str(tmp_path / "dicom"), "--out", str(tmp_path / "t.json")])
    assert j_cli.main(["build-index", "--root", str(tmp_path / "dicom"), "--out", str(tmp_path / "j.json")]) == 0
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert sorted(res["index"]) == sorted(json.loads((tmp_path / "j.json").read_text())) and len(res["index"]) >= 2


# ---------------------------------------------------------------------------
# N4, resize, registration
# ---------------------------------------------------------------------------


def test_n4_equals_jax():
    """A 20x24x16 head under a smooth multiplicative field: corrected volume and field equal JAX's exactly
    (the same numpy and scipy code), with and without a mask."""
    vol = np.maximum(_head((20, 24, 16), 7), 0)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in vol.shape], indexing="ij")
    biased = (vol * np.exp(0.4 * xx - 0.2 * zz)).astype(np.float32)
    got = t_n4.n4_bias_correction(biased, max_iterations=6, return_field=True)
    want = j_n4.n4_bias_correction(biased, max_iterations=6, return_field=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mask = vol > 100
    np.testing.assert_array_equal(t_n4.n4_bias_correction(biased, mask, max_iterations=3),
                                  j_n4.n4_bias_correction(biased, mask, max_iterations=3))


@pytest.mark.parametrize("shapes", [((13, 17, 9), (5, 29, 9)), ((31, 7, 4), (31, 23, 3)), ((9, 10, 11), (27, 5, 11))],
                         ids=lambda s: f"{s[0]}->{s[1]}")
def test_resize_linear_equals_jax_image_resize(shapes):
    """Odd sizes, shrinking and growing: the weights equal JAX's bit for bit, the 3-D resize within 1e-6
    (float32, the products in another order)."""
    from jax._src.image import scale as j_scale

    src, dst = shapes
    for n_in, n_out in zip(src, dst):
        if n_in != n_out:
            want = np.asarray(j_scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, j_scale._fill_triangle_kernel,
                                                         True)).T
            np.testing.assert_array_equal(t_resize._jax_linear_weights(n_in, n_out), want)
    x = np.random.default_rng(9).random(src).astype(np.float32)
    got = t_resize.resize_linear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.image.resize(jnp.asarray(x), dst, "linear")), atol=1e-6)
    np.testing.assert_allclose(t_reg.resample_to_grid(x, dst, device="cpu"), j_reg.resample_to_grid(x, dst), atol=1e-6)


def test_clip_gradient_is_jax_at_ties():
    """``jnp.clip``'s gradient: 0.5 at a tie with either bound (torch's ``clamp`` gives 1)."""
    x = torch.tensor([0.0, 1.0, 3.0, -1.0, 4.0], requires_grad=True)
    (g,) = torch.autograd.grad(t_reg._JaxClip.apply(x, torch.tensor(0.0), torch.tensor(3.0)).sum(), x)
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 3.0).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 1.0, 0.5, 0.0, 0.0]


S = 32
MOTION = (0.0, 0.0, np.deg2rad(3.0), 0.0, 2.0, 0.0)  # angles (rad), translations (voxels)


def _moved(fixed: np.ndarray, motion=MOTION) -> np.ndarray:
    """``fixed`` under the rigid motion: the volume whose registration onto ``fixed`` gives ``motion``."""
    rot = np.asarray(j_reg._euler_matrix(jnp.asarray(motion[:3], jnp.float32)))
    inverse = np.concatenate([-np.asarray(motion[:3]), -rot.T @ np.asarray(motion[3:])]).astype(np.float32)
    return np.asarray(j_reg._transform_and_sample(jnp.asarray(fixed), jnp.asarray(inverse), fixed.shape))


def _jax_params(fixed, moving, iterations=150, lr=0.05, downsample=4):
    """``register_rigid_jax``'s parameters (the function returns only the warped volume)."""
    import optax

    f, m = jnp.asarray(fixed), jnp.asarray(moving)
    f_n, m_n = (f - f.mean()) / (f.std() + 1e-6), (m - m.mean()) / (m.std() + 1e-6)
    small = tuple(max(8, s // downsample) for s in fixed.shape)
    fs, ms = jax.image.resize(f_n, small, "linear"), jax.image.resize(m_n, small, "linear")

    def loss(p):
        w = j_reg._transform_and_sample(ms, p, small)
        return -jnp.mean((w - w.mean()) / (w.std() + 1e-6) * fs)

    opt = optax.adam(lr)
    grad0 = jax.grad(loss)(jnp.zeros(6, jnp.float32))

    @jax.jit
    def step(p, s):
        u, s = opt.update(jax.grad(loss)(p), s)
        return optax.apply_updates(p, u), s

    p, s = jnp.zeros(6, jnp.float32), opt.init(jnp.zeros(6, jnp.float32))
    for _ in range(iterations):
        p, s = step(p, s)
    scale = np.array([a / b for a, b in zip(fixed.shape, small)], np.float32)
    return np.asarray(grad0), np.concatenate([np.asarray(p[:3]), np.asarray(p[3:]) * scale]), small


def test_registration_equals_jax():
    """A 32^3 head and its copy under 3 degrees about one axis and a 2-voxel shift: the loss gradient at the
    identity equals JAX's within 1e-6 (absolute; its largest element is ~0.1), the 6 parameters after 150
    Adam steps within 1e-5, and the warped volume within 5e-6 of the volume's largest value of
    ``register_rigid_jax``'s (where the image is steep the parameters' ~1e-6 moves a voxel by ~1e-6 of it)."""
    fixed = _head((S, S, S), 5)
    moving = _moved(fixed)
    grad0, want, small = _jax_params(fixed, moving)
    f = t_reg._normalised(torch.from_numpy(fixed))
    m = t_reg._normalised(torch.from_numpy(np.array(moving)))
    fs, ms = t_resize.resize_linear(f, small), t_resize.resize_linear(m, small)
    p = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad(-torch.mean(t_reg._normalised(t_reg._transform_and_sample(ms, p, small)) * fs), p)
    np.testing.assert_allclose(g.numpy(), grad0, atol=1e-6)
    got = t_reg.rigid_params(fixed, moving, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    warped = t_reg.register_rigid(fixed, moving, device="cpu")
    np.testing.assert_allclose(warped, j_reg.register_rigid_jax(fixed, moving), atol=5e-6 * float(np.abs(fixed).max()))


# ---------------------------------------------------------------------------
# preprocess-slices and SliceDataset
# ---------------------------------------------------------------------------


def test_preprocess_slices_equals_jax(tmp_path):
    """One pair (a flipped 64 mT grid and a 3 T grid) through both packages' ``preprocess-slices``: the same
    128 ``axial_vol_000_*.npz`` files, each array within 1e-6 of JAX's (values in [0, 1])."""
    bids = _bids(tmp_path / "bids", subjects=("sub-0001",))
    res = t_cli.run(["preprocess-slices", "--cpu", "--data-dir", str(bids), "--out", str(tmp_path / "t")])
    assert j_cli.main(["preprocess-slices", "--cpu", "--data-dir", str(bids), "--out", str(tmp_path / "j")]) == 0
    got, want = sorted((tmp_path / "t" / "axial").iterdir()), sorted((tmp_path / "j" / "axial").iterdir())
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 128 and res["slices"] == [128]
    for g, w in zip(got[::9], want[::9]):
        with np.load(g) as a, np.load(w) as b:
            for k in ("lr", "hr"):
                assert a[k].shape == b[k].shape == (512, 512) and a[k].dtype == b[k].dtype
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=f"{g.name} {k}")


def test_slice_dataset_with_n4_and_registration_equals_jax(tmp_path):
    """``SliceDataset(do_n4=True, register_fn=...)`` over two pairs (LR 16x20x12 under a bias field and a
    motion, HR 20x24x16), each package with its own registration (30 Adam steps): the items agree within
    2e-5 in [-1, 1]."""
    root = tmp_path / "bids"
    for i, sid in enumerate(("sub-0001", "sub-0002")):
        hr = np.maximum(_head((20, 24, 16), 30 + i), 0)
        zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in (16, 20, 12)], indexing="ij")
        lr = np.maximum(_moved(hr, (0.0, 0.0, 0.04, 0.5, 1.0, 0.0))[2:18, 2:22, 2:14], 0) * np.exp(0.3 * xx)
        (root / "64mT data" / sid / "ses-1" / "anat").mkdir(parents=True)
        (root / "3T data" / sid / "anat").mkdir(parents=True)
        write_nifti(root / "64mT data" / sid / "ses-1" / "anat" / f"{sid}_T1w.nii.gz", lr.astype(np.float32))
        write_nifti(root / "3T data" / sid / "anat" / f"{sid}_acq-highres_T1w.nii.gz", hr)
    from mrisr_tpu.data.bids import get_data_dicts as j_pairs
    from mrisr_torch.data.bids import get_data_dicts as t_pairs

    assert t_pairs(root) == j_pairs(root)
    kw = dict(do_n4=True, lr_clip=(0, 900), hr_clip=(0, 900))
    got = t_ds.SliceDataset(t_pairs(root), cache_dir=tmp_path / "tc", **kw,
                            register_fn=lambda fixed, moving: t_reg.register_rigid_torch(fixed, moving, iterations=30,
                                                                                         device="cpu"))
    want = j_ds.SliceDataset(j_pairs(root), cache_dir=tmp_path / "jc", **kw,
                             register_fn=lambda fixed, moving: j_reg.register_rigid_jax(fixed, moving, iterations=30))
    assert len(got) == len(want) == 32
    for i in range(0, 32, 5):
        a, b = got[i], want[i]
        assert a["subject_id"] == b["subject_id"] and a["hr"].shape == b["hr"].shape == (512, 512, 1)
        np.testing.assert_array_equal(a["hr"], b["hr"])
        np.testing.assert_allclose(a["lr"], b["lr"], atol=2e-5)


def test_data_commands_need_no_pil_but_for_a_jpeg(tmp_path, monkeypatch):
    """With PIL unimportable: ``export-png``, ``report`` and ``evaluate`` on PNGs run; a JPEG raises an
    ImportError that names the file."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(12)
    for i in range(2):
        np.savez(src / f"{i}.npz", hr=rng.random((16, 16)).astype(np.float32), lr=rng.random((16, 16)).astype(np.float32))
    Image.fromarray(rng.integers(0, 256, (16, 16), dtype=np.uint8)).save(tmp_path / "x.jpg")
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert t_cli.run(["export-png", "--source", str(src), "--dest", str(tmp_path / "png")])["pairs"] == 2
    res = t_cli.run(["evaluate", "--cpu", "--gen", str(tmp_path / "png" / "lr_images"),
                     "--gt", str(tmp_path / "png" / "hr_images")])["results"]
    assert res["count"] == 2 and np.isfinite(res["PSNR"])
    assert len(t_cli.run(["report", "--data-dir", str(_bids(tmp_path / "bids")), "--out", str(tmp_path / "r")])
               ["stats"]["montages"]) == 2
    with pytest.raises(ImportError, match="x.jpg"):
        t_png.read_gray(tmp_path / "x.jpg")


def test_card_entry_points_raise_without_cuda_unless_cpu(tmp_path, monkeypatch):
    """The evaluator, the registration, the resample and ``preprocess-slices`` / ``evaluate`` default to the
    card and raise without one; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 8, 8), np.float32)
    for make in (lambda: TEvaluator(), lambda: t_reg.register_rigid(vol, vol), lambda: t_reg.rigid_params(vol, vol),
                 lambda: t_reg.resample_to_grid(vol, (4, 4, 4)),
                 lambda: t_cli.run(["preprocess-slices", "--data-dir", str(tmp_path), "--out", str(tmp_path / "o")]),
                 lambda: t_cli.run(["evaluate", "--gen", str(tmp_path), "--gt", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert TEvaluator(device="cpu").device.type == "cpu"
