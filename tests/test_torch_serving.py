"""The port's serving family against the JAX package, on the CPU.

The Flax msgpack reader, the MRI metrics, the NIfTI and slice helpers, the
volume driver, the DDPM chain and the port's bench entry point.  Inputs are
numpy draws from fixed seeds, handed to both packages.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mrisr_tpu.data import nifti as j_nifti
from mrisr_tpu.diffusion import ddpm as j_ddpm
from mrisr_tpu.diffusion.schedules import resdiff_schedule as j_resdiff_schedule
from mrisr_tpu.eval import metrics as j_metrics
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_tpu.pipelines import sampler as j_sampler
from mrisr_tpu.pipelines import volume as j_volume
from mrisr_torch.data import nifti as t_nifti
from mrisr_torch.diffusion import ddpm as t_ddpm
from mrisr_torch.diffusion.schedules import resdiff_schedule
from mrisr_torch.eval import metrics as t_metrics
from mrisr_torch.models.resdiff_unet import ResDiffUNet as TUNet
from mrisr_torch.models.simple_cnn import SimpleCNN as TCNN
from mrisr_torch.pipelines import sampler as t_sampler
from mrisr_torch.pipelines import volume as t_volume
from mrisr_torch.pipelines.resdiff import ResDiffPipeline
from mrisr_torch.utils.flax_msgpack import read_msgpack
from mrisr_torch.weights import load_flax_checkpoint, load_flax_params
from test_torch_resdiff import flax_random_params, to_numpy, to_torch
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "ckpt_256_r3.msgpack"
TINY = dict(image_size=32, inner_channel=8, norm_groups=4)


def _same_leaves(got, want):
    """Same tree, leaf types and dtypes, and every leaf bitwise equal."""
    g, w = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert type(a) is type(b), path
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    return len(g)


def test_reader_equals_flax_on_every_leaf_of_the_checkpoint():
    data = CKPT.read_bytes()
    got, want = read_msgpack(data), serialization.msgpack_restore(data)
    assert set(got) == {"params", "ema", "opt_state", "step"} and got["step"] == 60000
    assert _same_leaves(got, want) == 863
    for tree in ("params", "ema"):
        leaves = jax.tree_util.tree_leaves(got[tree])
        assert len(leaves) == 215 and sum(x.size for x in leaves) == 4065294
        assert all(x.dtype == np.float32 for x in leaves)
    assert _same_leaves(read_msgpack(CKPT), want)  # a path reads as its bytes


def test_reader_takes_every_ext_type_and_chunked_arrays(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "chunked": rng.standard_normal((7, 9)).astype(np.float32),  # 252 bytes: chunks of 64
        "ints": np.arange(40, dtype=np.int64).reshape(2, 4, 5),
        "small": np.array([1, -2, 3], np.int16),
        "npscalar": np.float32(2.5),
        "npint": np.int32(-7),
        "complex": complex(1.5, -2.25),
        "scalars": {"nil": None, "yes": True, "no": False, "fix": 5, "neg": -3, "u8": 200, "u16": 60000,
                    "u32": 2**31, "u64": 2**63, "i8": -100, "i16": -30000, "i32": -2**31, "i64": -2**62,
                    "f": 0.1, "inf": float("inf")},
        "text": {"short": "x", "long": "é" * 40, "bin": b"\x00\x01" * 200},
        "list": [1, "two", [3.0, None], {"k": np.zeros((0, 3), np.float64)}],
        "big_map": {f"k{i}": i for i in range(20)},
        "big_list": list(range(20)),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got, want = read_msgpack(data), serialization.msgpack_restore(data)
    _same_leaves(got, want)
    assert got["chunked"].shape == (7, 9) and np.array_equal(got["chunked"], tree["chunked"])
    assert got["complex"] == tree["complex"] and got["npscalar"] == np.float32(2.5)
    assert got["scalars"] == want["scalars"] and got["text"] == want["text"]


def test_reader_widens_bfloat16_exactly():
    x = jnp.asarray(np.random.default_rng(1).standard_normal((3, 5)), jnp.bfloat16)
    data = serialization.msgpack_serialize({"w": x})
    got = read_msgpack(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_reader_rejects_bad_data():
    with pytest.raises(ValueError):
        read_msgpack(b"\xc1")
    with pytest.raises(ValueError):
        read_msgpack(b"\x92\x01")  # an array of two with one element
    with pytest.raises(ValueError):
        read_msgpack(b"\x01\x02")  # bytes after the value
    with pytest.raises(ValueError):
        read_msgpack(b"\xd4\x07\x00")  # an ext type Flax does not write


def test_checkpoint_loads_into_the_port_unet():
    unet = TUNet(image_size=256, inner_channel=32, norm_groups=8, device="cpu")
    tree = load_flax_checkpoint(unet, CKPT)
    ema = tree["ema"]["params"]
    np.testing.assert_array_equal(unet.conv_in.weight.detach().numpy(), ema["conv_in"]["kernel"].transpose(3, 2, 0, 1))
    assert sum(p.numel() for p in unet.parameters()) == 4065294


def _image_pairs(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    # A smooth image (local structure for SSIM) plus noise of a few levels.
    target = 0.5 + 0.4 * np.sin(np.linspace(0, 6, shape[-1]))[None, None, None, :] * target
    pred = np.clip(target + rng.normal(0.0, 0.05, shape), 0, 1).astype(np.float32)
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((2, 1, 32, 32), 0), ((3, 2, 24, 40), 1), ((1, 1, 64, 48), 2)])
def test_metrics_match_jax(shape, seed):
    """Each tensor-level metric at fp32 against the reference's, atol 1e-5 (fp32 sums in other orders)."""
    pred, target = _image_pairs(shape, seed)
    jp, jt, tp, tt = jnp.asarray(pred), jnp.asarray(target), torch.from_numpy(pred), torch.from_numpy(target)
    for name in ("psnr", "ssim", "nmse", "hfen_laplacian"):
        want = np.asarray(getattr(j_metrics, name)(jp, jt))
        got = getattr(t_metrics, name)(tp, tt).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(t_metrics.nmse(tp, tt, squared=True).numpy(),
                               np.asarray(j_metrics.nmse(jp, jt, squared=True)), atol=1e-5, rtol=0)
    for got, want in zip(t_metrics.compute_mri_metrics(tp, tt), j_metrics.compute_mri_metrics(jp, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    per_t = t_metrics.compute_mri_metrics_per_image(tp, tt)
    per_j = j_metrics.compute_mri_metrics_per_image(jp, jt)
    for got, want in zip(per_t, per_j):
        assert got.shape == (shape[0],)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert t_metrics.hfen_log(pred[0, 0], target[0, 0]) == j_metrics.hfen_log(pred[0, 0], target[0, 0])


def _affine():
    """A non-RAS affine: axes permuted and flipped, anisotropic voxels, an offset."""
    return np.array([[0.0, 0.0, -2.0, 90.0], [-1.2, 0.0, 0.0, 100.0], [0.0, 0.9, 0.0, -70.0], [0, 0, 0, 1]])


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_nifti_round_trip_reads_as_the_reference(tmp_path, suffix, dtype):
    vol = (np.random.default_rng(3).standard_normal((9, 7, 5)) * 300).astype(dtype)
    for writer, name in ((t_nifti.write_nifti, "port"), (j_nifti.write_nifti, "jax")):
        path = tmp_path / f"{name}{suffix}"
        writer(path, vol, _affine())
        got, want = t_nifti.read_nifti(path), j_nifti.read_nifti(path)
        np.testing.assert_array_equal(got.data, vol)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        assert got.header == want.header
        ras_t, ras_j = t_nifti.to_ras(got), j_nifti.to_ras(want)
        np.testing.assert_array_equal(ras_t.data, ras_j.data)
        np.testing.assert_array_equal(ras_t.affine, ras_j.affine)
        assert t_nifti.io_orientation(got.affine) == j_nifti.io_orientation(want.affine) == [(1, -1), (2, 1), (0, -1)]
    assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes() or suffix == ".nii.gz"


@pytest.mark.parametrize("shape,axis,resolution", [
    ((20, 12, 3), 2, 16),   # cropped in h and padded in w (tests/test_volume_chains.py's mixed case)
    ((12, 10, 4), 2, 16),   # padded in both: the vectorized restack
    ((5, 30, 18), 0, 24),   # cropped in h, padded in w, along axis 0
    ((16, 16, 2), 2, 16),   # the resolution itself
])
def test_volume_slices_and_restack_match_jax(shape, axis, resolution):
    vol = np.random.default_rng(4).uniform(-100, 1100, shape).astype(np.float32)
    got, shapes = t_volume.volume_to_model_slices(vol, axis, resolution)
    want, want_shapes = j_volume.volume_to_model_slices(vol, axis, resolution)
    np.testing.assert_array_equal(got, want)
    assert shapes == want_shapes
    sr = np.random.default_rng(5).uniform(-1, 1, got.shape).astype(np.float32)
    np.testing.assert_array_equal(t_volume.restack_slices(sr, shapes, axis), j_volume.restack_slices(sr, shapes, axis))


class _JaxStub:
    """A deterministic stand-in for a JAX pipeline: LR flipped along W, halved."""

    def super_resolve(self, lr, key, num_steps=50):
        return lr[:, :, ::-1, :] * 0.5

    def super_resolve_group(self, stack, keys, num_steps=50):
        return stack[:, :, :, ::-1, :] * 0.5


class _PortStub:
    device = torch.device("cpu")

    def __init__(self):
        self.seeds = []

    def super_resolve(self, lr, generator=None, x_T=None, num_steps=50):
        self.seeds.append(generator.initial_seed())
        return torch.flip(lr, dims=[2]) * 0.5

    def super_resolve_group(self, stack, generator=None, num_steps=50):
        self.seeds.extend(g.initial_seed() for g in generator)
        return torch.flip(stack, dims=[3]) * 0.5


@pytest.mark.parametrize("shape", [(20, 18, 5), (40, 12, 7)])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_super_resolve_volume_matches_jax_with_a_stub(tmp_path, shape, group):
    vol = np.random.default_rng(6).uniform(0, 1000, shape).astype(np.float32)
    src = tmp_path / "in.nii.gz"
    t_nifti.write_nifti(src, vol, _affine())
    kw = dict(axis=2, resolution=24, batch_size=2, num_steps=3, seed=5, chain_group=group)
    stub = _PortStub()
    got = t_volume.super_resolve_volume(stub, src, tmp_path / "port.nii", **kw)
    want = j_volume.super_resolve_volume(_JaxStub(), src, tmp_path / "jax.nii", **kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_array_equal(t_nifti.read_nifti(tmp_path / "port.nii").data, want.data)
    n = t_nifti.to_ras(t_nifti.read_nifti(src)).data.shape[2]  # slices along axis 2 after reorientation
    starts = list(range(0, -(-n // 2) * 2, 2))
    # One chain per batch: the last group is short where G does not divide the batches.
    assert stub.seeds == [t_volume.batch_generator(stub.device, 5, s).initial_seed() for s in starts]


@pytest.fixture(scope="module")
def tiny_pipeline():
    torch.manual_seed(0)
    return ResDiffPipeline(TCNN(device="cpu"), TUNet(**TINY, device="cpu"), resdiff_schedule(1000), device="cpu")


def test_grouped_dispatch_equals_serial_with_a_real_unet(tmp_path, tiny_pipeline):
    vol = np.random.default_rng(7).uniform(0, 1000, (30, 26, 5)).astype(np.float32)
    src = tmp_path / "in.nii"
    t_nifti.write_nifti(src, vol, np.eye(4))
    kw = dict(resolution=32, batch_size=2, num_steps=2, seed=3)
    serial = t_volume.super_resolve_volume(tiny_pipeline, src, **kw)
    grouped = t_volume.super_resolve_volume(tiny_pipeline, src, chain_group=2, **kw)
    assert serial.data.shape == vol.shape and np.isfinite(serial.data).all()
    np.testing.assert_array_equal(grouped.data, serial.data)
    other_seed = t_volume.super_resolve_volume(tiny_pipeline, src, **{**kw, "seed": 4})
    assert not np.array_equal(other_seed.data, serial.data)


def test_volume_feeds_the_pipeline_its_dtype(tiny_pipeline):
    assert t_volume.pipeline_dtype(tiny_pipeline) == torch.float32
    half = ResDiffPipeline(TCNN(device="cpu").to(torch.bfloat16), TUNet(**TINY, device="cpu").to(torch.bfloat16),
                           resdiff_schedule(1000), device="cpu")
    assert t_volume.pipeline_dtype(half) == torch.bfloat16
    assert t_volume.pipeline_dtype(_PortStub()) == torch.float32


def _jax_noise(key, steps, shape):
    """The reference chain's per-step draws: the key split once a step."""
    def split(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, shape, jnp.float32)

    return np.array(jax.lax.scan(split, key, None, length=steps)[1])


@pytest.mark.parametrize("t", [0, 1, 17, 999])
def test_p_step_matches_jax_with_its_noise(t):
    rng = np.random.default_rng(8 + t)
    x, eps = (rng.standard_normal((2, 6, 5, 1)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t)
    tb = np.full((2,), t, np.int32)
    want = j_ddpm.p_step(j_resdiff_schedule(1000), jnp.asarray(x), jnp.asarray(tb), jnp.asarray(eps), key)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = t_ddpm.p_step(resdiff_schedule(1000), torch.from_numpy(x), torch.from_numpy(tb).long(),
                        torch.from_numpy(eps), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    for a, b in zip(t_ddpm.posterior_mean_variance(resdiff_schedule(1000), torch.from_numpy(eps), torch.from_numpy(x),
                                                   torch.from_numpy(tb).long()),
                    j_ddpm.posterior_mean_variance(j_resdiff_schedule(1000), jnp.asarray(eps), jnp.asarray(x),
                                                   jnp.asarray(tb))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


def test_four_ancestral_steps_match_jax_with_its_noise():
    """The full-length SR3 chain of a 4-step schedule over a tiny UNet, fp32, JAX's draws injected.

    Tolerance: the North-star forward bar (atol 2e-4, rtol 1e-3) after four chained UNet evaluations.
    """
    junet = JUNet(**TINY, dropout=0.0)
    params = flax_random_params(junet, (jnp.zeros((1, 32, 32, 2)), jnp.array([0.5])), seed=21)
    tunet = TUNet(**TINY, device="cpu")
    load_flax_params(tunet, params)
    rng = np.random.default_rng(9)
    cond, x_T = (rng.standard_normal((2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(4)

    def eps_j(x, gamma):
        return junet.apply(params, jnp.concatenate([jnp.asarray(cond), x], axis=-1), gamma)

    def eps_t(x, gamma):
        return tunet(torch.cat([to_torch(cond), x], dim=1), gamma)

    want = j_sampler.sr3_ancestral_sample(j_resdiff_schedule(4), eps_j, jnp.asarray(x_T), key, num_steps=None)
    noise = _jax_noise(key, 4, (2, 32, 32, 1)).transpose(0, 1, 4, 2, 3)
    with torch.no_grad():
        got = t_sampler.sr3_ancestral_sample(resdiff_schedule(4), eps_t, to_torch(x_T), num_steps=None,
                                             noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4, rtol=1e-3)


def test_ddpm_sample_matches_jax_with_its_noise():
    x_T = np.random.default_rng(10).standard_normal((2, 4, 4, 1)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def eps_j(x, t):
        return 0.2 * x + 1e-4 * t[:, None, None, None].astype(jnp.float32)

    def eps_t(x, t):
        return 0.2 * x + 1e-4 * t[:, None, None, None].float()

    want = j_sampler.ddpm_sample(j_resdiff_schedule(50), eps_j, jnp.asarray(x_T), key)
    noise = torch.from_numpy(_jax_noise(key, 50, x_T.shape))
    got = t_sampler.ddpm_sample(resdiff_schedule(50), eps_t, torch.from_numpy(x_T), noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="noise"):
        t_sampler.ddpm_sample(resdiff_schedule(50), eps_t, torch.from_numpy(x_T), noise=noise[:3])


def test_ancestral_chain_draws_from_the_generator(tiny_pipeline):
    """``num_steps=None`` through the pipeline: the same generator seed gives the same chain."""
    pipe = ResDiffPipeline(tiny_pipeline.cnn, tiny_pipeline.unet, resdiff_schedule(6), device="cpu")
    lr = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1, (1, 32, 32, 1)).astype(np.float32))
    a = pipe.super_resolve(lr, torch.Generator().manual_seed(1), num_steps=None)
    b = pipe.super_resolve(lr, torch.Generator().manual_seed(1), num_steps=None)
    c = pipe.super_resolve(lr, torch.Generator().manual_seed(2), num_steps=None)
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)


def test_cpu_pipeline_runs_eagerly_and_group_takes_a_generator_per_chain(tiny_pipeline):
    assert tiny_pipeline.cuda_graph is False and tiny_pipeline.graphs == {}
    lr = torch.from_numpy(np.random.default_rng(12).uniform(-1, 1, (2, 1, 32, 32, 1)).astype(np.float32))
    gens = [torch.Generator().manual_seed(s) for s in (3, 4)]
    out = tiny_pipeline.super_resolve_group(lr, gens, num_steps=2)
    for g, seed in enumerate((3, 4)):
        one = tiny_pipeline.super_resolve(lr[g], torch.Generator().manual_seed(seed), num_steps=2)
        torch.testing.assert_close(out[g], one, atol=0, rtol=0)
    with pytest.raises(ValueError, match="generators"):
        tiny_pipeline.super_resolve_group(lr, gens[:1], num_steps=2)
    assert tiny_pipeline.graphs == {}


def test_launch_counts_reset_and_read_every_kernel(tiny_pipeline):
    from mrisr_torch.ops import flash_attention, groupnorm, launch_counts, reset_launch_counts

    flash_attention.flash_attention_fwd.launches = 3
    groupnorm.group_norm_silu.launches = 5
    assert launch_counts() == {"flash_attention_fwd": 3, "flash_attention_bwd_dq": 0,
                               "flash_attention_bwd_dkv": 0, "group_norm_silu": 5}
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(launch_counts(), 0) and len(launch_counts()) == 4
    # A CPU chain runs the plain versions: no wrapper launches a kernel.
    lr = torch.zeros((1, 32, 32, 1))
    tiny_pipeline.super_resolve(lr, torch.Generator().manual_seed(0), num_steps=1)
    assert set(launch_counts().values()) == {0}


def test_recording_shapes_nests_and_notes_only_kernel_launches(tiny_pipeline, monkeypatch):
    from mrisr_torch import ops
    from mrisr_torch.ops import flash_attention, groupnorm

    wrappers = (flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd, groupnorm.group_norm_silu)
    lr = torch.zeros((1, 32, 32, 1))
    x, w, b = torch.randn(2, 8, 4, 4), torch.ones(8), torch.zeros(8)
    # The launch stands in for the kernel, so that the wrapper's bookkeeping after it runs on the CPU.
    monkeypatch.setattr(groupnorm, "_launch", lambda x, w, b, g, eps: groupnorm.group_norm_silu_plain(x, w, b, g, eps))
    monkeypatch.setattr(groupnorm.group_norm_silu, "launches", 0)
    with ops.recording_shapes() as outer:
        groupnorm._forward(x, w, b, 4, 1e-5)
        with ops.recording_shapes() as inner:
            assert all(len(fn.shapes) == 2 for fn in wrappers)
            groupnorm._forward(x, w, b, 2, 1e-6)
            # A CPU chain runs the plain versions: no wrapper launches a kernel, so none notes one.
            tiny_pipeline.super_resolve(lr, torch.Generator().manual_seed(0), num_steps=1)
        assert all(len(fn.shapes) == 1 for fn in wrappers)
    assert all(fn.shapes == [] for fn in wrappers)
    assert set(outer) == set(inner) == {"flash_attention_fwd", "flash_attention_bwd", "group_norm_silu"}
    assert outer["group_norm_silu"] == {((2, 8, 4, 4), 4, 1e-5, torch.float32): 1,
                                        ((2, 8, 4, 4), 2, 1e-6, torch.float32): 1}
    assert inner["group_norm_silu"] == {((2, 8, 4, 4), 2, 1e-6, torch.float32): 1}
    assert not outer["flash_attention_fwd"] and not outer["flash_attention_bwd"]
    assert groupnorm.group_norm_silu.launches == 2


def test_port_bench_prints_one_json_line_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "mrisr_torch.bench", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, check=True)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "per_rep_blocked_ms", "per_rep_stdev_ms", "device", "power_limit"} <= set(rec)
    assert rec["unit"] == "slices/sec/gpu" and rec["value"] > 0 and rec["device"] == "cpu"
    assert rec["power_limit"] is None and rec["cuda_graph"] is False and "vs_baseline" not in rec
    assert len(rec["per_rep_blocked_ms"]) == 1


def test_port_imports_no_flax_or_msgpack():
    """Besides the JAX packages (``test_torch_ops.py``): no flax, msgpack or the reference package."""
    import ast

    files = sorted((REPO / "mrisr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"mrisr_torch/utils/flax_msgpack.py", "mrisr_torch/eval/metrics.py", "mrisr_torch/pipelines/volume.py",
            "mrisr_torch/bench.py"} <= {str(f.relative_to(REPO)) for f in files}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not {n.split(".")[0] for n in names} & {"jax", "flax", "msgpack", "mrisr_tpu"}, path
