"""The port's fidelity harness (``mrisr_torch/eval/parity.py``) against the JAX package's, on the CPU.

The helpers (statistics, metrics, phantoms) against JAX's; the stage-1 leg
trained from JAX's initial weights; the stage-2 leg at 128^2 with the
profile sweep and 0 training steps, JAX's initial weights and its chain
noise handed over (every row's PSNR within 0.01 dB per image); the report's
key tree against JAX's; ``--resume-ckpt`` bitwise; a JAX ``--ckpt`` file
read into the port; a pipeline fed new weights in place against a fresh one.
The JAX run is a module fixture, made once.  The latent leg is
``test_torch_parity_latent.py``.
"""
from __future__ import annotations

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu.eval import parity as j_parity
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_tpu.models.simple_cnn import SimpleCNN as JCNN
from mrisr_tpu.ops.space_to_depth import depth_to_space
from mrisr_tpu.train import state as j_state
from mrisr_torch import cli as t_cli
from mrisr_torch.diffusion.schedules import resdiff_schedule
from mrisr_torch.eval import parity as t_parity
from mrisr_torch.models.resdiff_unet import ResDiffUNet as TUNet
from mrisr_torch.models.simple_cnn import SimpleCNN as TCNN
from mrisr_torch.pipelines.resdiff import ResDiffPipeline
from mrisr_torch.train import state as t_state
from mrisr_torch.weights import flax_named, load_flax_train_checkpoint
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from test_torch_resdiff import flax_random_params

PSNR_BAR_DB = 0.01  # per image, the repository's bar


def _named(module, tree):
    """A Flax tree as the port's ``{name: tensor}`` for ``module``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in flax_named(module, tree).items()}


def _keys(tree):
    """The key tree of a report: dicts by key, lists and leaves as their type's name."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return "list" if isinstance(tree, list) else "number" if isinstance(tree, (int, float)) else type(tree).__name__


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_seeds", [1, 2, 3])
def test_paired_delta_stats_match_jax(n_seeds):
    rng = np.random.default_rng(n_seeds)
    a, b = rng.normal(30, 2, 12).tolist(), rng.normal(30, 2, 12).tolist()
    got, want = t_parity._paired_delta_stats(a, b, n_seeds), j_parity._paired_delta_stats(a, b, n_seeds)
    assert _keys(got) == _keys(want) and ("clustered_by_image" in got) == (n_seeds > 1)
    np.testing.assert_allclose(_flat(got), _flat(want), rtol=1e-6)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [float(x) for x in tree] if isinstance(tree, list) else [float(tree)]


def test_metrics_match_jax():
    """``_metrics`` and ``_metrics_per_image`` (NHWC, clipped to [0, 1]) within 1e-6 relative."""
    rng = np.random.default_rng(3)
    hr = rng.random((3, 24, 24, 1)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.1, hr.shape), -0.2, 1.2).astype(np.float32)
    got, want = t_parity._metrics(sr, hr), j_parity._metrics(sr, hr)
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)
    got, want = t_parity._metrics_per_image(sr, hr), j_parity._metrics_per_image(sr, hr)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


@pytest.mark.parametrize("textured,mode", [(True, "recoverable"), (True, "legacy"), (False, "recoverable")])
def test_phantom_batches_match_jax(textured, mode):
    """HR bitwise; the LR (the port's PIL-free degradation) within the data tests' 1e-6."""
    got = t_parity._phantom_batches(3, 64, seed0=5, textured=textured, texture_mode=mode)
    want = j_parity._phantom_batches(3, 64, seed0=5, textured=textured, texture_mode=mode)
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

CNN_RES = 32


def test_run_phantom_cnn_matches_jax():
    """10 steps (Adam 1e-4, bs 4 of 8 phantoms) from JAX's ``PRNGKey(0)`` weights: parameters within 1e-5,
    PSNR within 1e-3 dB, the report's keys."""
    init = JCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, CNN_RES, CNN_RES, 1)))
    want = j_parity.run_phantom_cnn(10, CNN_RES, batch=4, n_train=8)
    cnn = TCNN(device="cpu")
    got = t_parity.run_phantom_cnn(10, CNN_RES, batch=4, n_train=8, device="cpu", params=_named(cnn, init))
    assert set(got) == set(want) and got["steps"] == want["steps"] == 10
    for name, w in flax_named(cnn, want["cnn_params"]).items():
        np.testing.assert_allclose(got["cnn_params"][name].numpy(), w, atol=1e-5, err_msg=name)
    for part in ("model", "bicubic_baseline"):
        assert abs(got[part]["psnr"] - want[part]["psnr"]) < 1e-3, part


def test_run_fastmri_cnn_matches_jax(tmp_path):
    """The FastMRI leg on a synthetic DICOM tree (24 patients x 2 slices, 15 of them 3 T T2; the data tests'
    writer) and its index: 3 steps of bs 2 at 32^2 from JAX's ``PRNGKey(0)`` weights, then the mean metrics
    over the test split: the report's keys, the slice count, PSNR within 1e-3 dB, the anchor."""
    from mrisr_torch.data.datasets import build_patient_index
    from mrisr_torch.data.dicom import write_dicom_minimal
    from test_torch_data import _dicom_tree

    root = _dicom_tree(tmp_path / "tree", write_dicom_minimal, n_patients=24, slices=2)
    index = tmp_path / "index.json"
    build_patient_index(root, index)
    init = JCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, CNN_RES, CNN_RES, 1)))
    want = j_parity.run_fastmri_cnn(str(index), steps=3, res=CNN_RES, batch=2)
    got = t_parity.run_fastmri_cnn(str(index), steps=3, res=CNN_RES, batch=2, device="cpu",
                                   params=_named(TCNN(device="cpu"), init))
    assert _keys(got) == _keys(want) and got["n_test"] == want["n_test"] > 0
    assert abs(got["model"]["psnr"] - want["model"]["psnr"]) < 1e-3 and got["anchor"] == want["anchor"]


# ---------------------------------------------------------------------------
# Stage 2 at 128^2 with the profile sweep, untrained: JAX's weights and noise handed over
# ---------------------------------------------------------------------------

RD = dict(res=128, batch=4, n_train=4, inner_channel=8, sample_steps=(2,), n_test=8, sample_seeds=(2, 3),
          profile_steps=2)


def _jax_x_T(junet, res, grouped):
    """The starting noise JAX's ``_sample`` gives chain g under ``seed`` (``fold_in(PRNGKey(seed), g)`` when the
    set runs as several chains, else ``PRNGKey(seed)``; then ``pipelines/resdiff.py``'s first split, drawn in
    the space-to-depth shape where the UNet runs so), as ``[B, H, W, 1]``."""
    s2d = junet.s2d_eligible(res, res)

    def noise(seed, g, shape):
        key = jax.random.PRNGKey(seed)
        key = jax.random.fold_in(key, g) if grouped else key
        _, k0 = jax.random.split(key)
        b = shape[0]
        if s2d:
            x = depth_to_space(jax.random.normal(k0, (b, res // 2, res // 2, 4), jnp.float32))
        else:
            x = jax.random.normal(k0, (b, res, res, 1), jnp.float32)
        return torch.from_numpy(np.array(x))

    return noise


@pytest.fixture(scope="module")
def resdiff_runs():
    res = RD["res"]
    cnn_init = JCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, 1)))
    junet = JUNet(image_size=res, inner_channel=RD["inner_channel"], norm_groups=8)
    unet_init = junet.init(jax.random.PRNGKey(1), jnp.zeros((1, res, res, 2)), jnp.array([0.5]))
    want = j_parity.run_phantom_resdiff({"cnn_params": cnn_init}, steps=0, **RD)
    cnn = TCNN(device="cpu")
    unet = TUNet(image_size=res, inner_channel=RD["inner_channel"], norm_groups=8, device="cpu")
    got = t_parity.run_phantom_resdiff({"cnn_params": _named(cnn, cnn_init)}, steps=0, device="cpu",
                                       params=_named(unet, unet_init),
                                       noise=_jax_x_T(junet, res, RD["n_test"] > RD["batch"]), **RD)
    return want, got


def test_phantom_resdiff_untrained_matches_jax_per_image(resdiff_runs):
    """Every row: the chain sweep's means, stage 1, bicubic, and the exact and three kv-pool profiles' per-image
    PSNR within 0.01 dB; the paired statistics and verdicts computed from them agree."""
    want, got = resdiff_runs
    assert _keys(got) == _keys(want)
    for k in ("2",):
        assert abs(got["by_sample_steps"][k]["psnr"] - want["by_sample_steps"][k]["psnr"]) < PSNR_BAR_DB
    for row in ("stage1_cnn", "bicubic_baseline", "model", "best_chain"):
        assert abs(got[row]["psnr"] - want[row]["psnr"]) < PSNR_BAR_DB, row
    profs = got["profiles_50step"]
    assert set(profs) == {"sample_steps", "exact", "kv_pool_2", "kv_pool_4", "kv_pool_8"}
    for name in ("exact", "kv_pool_2", "kv_pool_4", "kv_pool_8"):
        g, w = np.array(profs[name]["per_image"]["psnr"]), np.array(want["profiles_50step"][name]["per_image"]["psnr"])
        assert g.shape == (16,) and np.abs(g - w).max() < PSNR_BAR_DB, name
    for name in ("kv_pool_2", "kv_pool_4", "kv_pool_8"):
        d, dw = profs[name]["delta_vs_exact"]["psnr"], want["profiles_50step"][name]["delta_vs_exact"]["psnr"]
        assert d["n"] == 16 and d["clustered_by_image"]["n"] == 8
        assert abs(d["mean"] - dw["mean"]) < PSNR_BAR_DB
        assert profs[name]["config"] == want["profiles_50step"][name]["config"]
    assert got["fast_profiles_50step"].keys() == {"2", "4", "8"}


def test_sample_set_after_an_in_place_weight_copy_equals_a_fresh_pipeline():
    """The stand-in on the CPU for a graphed chain after a weight copy: a pipeline built with one set of UNet
    weights, then given another through ``sample_set`` (copied in place), gives what a pipeline built with
    the second set gives, bitwise; the UNet's tensors stay where they were."""
    torch.manual_seed(0)
    cnn = TCNN(device="cpu")
    kw = dict(image_size=32, inner_channel=8, norm_groups=4, device="cpu")
    first, second = TUNet(**kw), TUNet(**kw)
    lr = torch.rand(4, 32, 32, 1)
    pipe = ResDiffPipeline(cnn, first, resdiff_schedule(1000), device="cpu")
    ptrs = [p.data_ptr() for p in pipe.unet.parameters()]
    t_parity.sample_set(pipe, dict(first.named_parameters()), lr, 2, 5, 3)
    new = {k: v.detach().clone() for k, v in second.named_parameters()}
    got = t_parity.sample_set(pipe, new, lr, 2, 5, 3)
    fresh = ResDiffPipeline(cnn, TUNet(**kw), resdiff_schedule(1000), device="cpu")
    want = t_parity.sample_set(fresh, new, lr, 2, 5, 3)
    assert torch.equal(got, want) and [p.data_ptr() for p in pipe.unet.parameters()] == ptrs


# ---------------------------------------------------------------------------
# The whole harness: key tree, --ckpt and --resume-ckpt, a JAX checkpoint
# ---------------------------------------------------------------------------

CLI_TINY = ["--cpu", "--skip-mnist", "--resolution", "32", "--n-train", "8", "--batch", "4", "--phantom-steps", "2",
            "--inner-channel", "8", "--sample-steps", "2", "--n-test", "8"]


def test_parity_cli_writes_the_references_key_tree(tmp_path, resdiff_runs):
    """``parity --cpu`` at 128^2 against JAX's ``run_parity`` at the same flags: the same key tree and config on
    disk.  Both packages' stage-2 legs stand in by this module's runs of them (whose trees are held to each
    other above); the port's stage-1 leg runs."""
    want_rd, got_rd = resdiff_runs
    cnn = {"steps": 2, "model": want_rd["stage1_cnn"], "bicubic_baseline": want_rd["bicubic_baseline"],
           "cnn_params": None}
    with mock.patch.object(j_parity, "run_phantom_cnn", return_value=cnn), \
            mock.patch.object(j_parity, "run_phantom_resdiff", return_value=want_rd):
        j_parity.run_parity(tmp_path / "jax.json", skip_mnist=True, res=128, n_train=8, batch=4, inner_channel=8,
                            n_test=8, sample_seeds=(2, 3), sample_steps=(2,))
    with mock.patch.object(t_parity, "run_phantom_resdiff", return_value=got_rd):
        t_cli.run(["parity", *CLI_TINY, "--out", str(tmp_path / "port.json"), "--resolution", "128",
                   "--sample-seeds", "2,3"])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"] and got["anchors"] == want["anchors"]


def test_bench_command_runs_the_port_bench_in_process(capsys):
    """``bench --cpu-smoke`` is ``mrisr_torch.bench --device cpu`` in this process: its JSON line, unchanged."""
    assert t_cli.run(["bench", "--cpu-smoke"]) == {"rc": 0}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "slices/sec/gpu" and line["device"] == "cpu" and line["value"] > 0


def test_resume_ckpt_is_bitwise(tmp_path):
    """``--resdiff-steps 4 --eval-every 2 --ckpt`` against 2 steps with ``--ckpt`` and then ``--resume-ckpt`` to
    4: the same parameters, EMA, Adam state and step in the final checkpoint (written atomically: no
    ``.tmp`` left)."""
    base = ["parity", *CLI_TINY, "--eval-every", "2", "--chunk-steps", "2", "--sample-steps", "1"]
    t_cli.run([*base, "--out", str(tmp_path / "a.json"), "--resdiff-steps", "4", "--ckpt", str(tmp_path / "a.pt")])
    t_cli.run([*base, "--out", str(tmp_path / "b.json"), "--resdiff-steps", "2", "--ckpt", str(tmp_path / "b.pt")])
    t_cli.run([*base, "--out", str(tmp_path / "b.json"), "--resdiff-steps", "4", "--ckpt", str(tmp_path / "b.pt"),
               "--resume-ckpt", str(tmp_path / "b.pt")])
    a = torch.load(tmp_path / "a.pt", weights_only=True)
    b = torch.load(tmp_path / "b.pt", weights_only=True)
    assert a["step"] == b["step"] == 4 and not list(tmp_path.glob("*.tmp"))

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree]

    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert json.loads((tmp_path / "a.json").read_text())["phantom_resdiff"] == \
        json.loads((tmp_path / "b.json").read_text())["phantom_resdiff"]


def test_a_jax_ckpt_file_is_read_into_the_port(tmp_path):
    """A ``--ckpt`` file as the JAX harness writes it (``serialization.to_bytes`` of params, EMA, Adam's state
    under a cosine schedule, step) read by ``load_flax_train_checkpoint``, and by the harness's resume: the
    parameters, EMA, ``mu``, ``nu`` and ``count`` in the port's layout, and the step."""
    from flax import serialization

    kw = dict(image_size=16, inner_channel=8, norm_groups=4)
    junet = JUNet(**kw)
    rng = np.random.default_rng(4)
    trees = [flax_random_params(junet, (jnp.zeros((1, 16, 16, 2)), jnp.array([0.5])), seed=s) for s in (1, 2)]
    tx = j_state.make_optimizer(optax.cosine_decay_schedule(2e-4, 10, alpha=0.05))
    js = j_state.create_train_state(junet.apply, trees[0], tx, ema_decay=0.99)
    adam = js.opt_state[0]
    moments = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.random(p.shape).astype(np.float32)), (adam.mu, adam.nu))
    opt_state = (adam._replace(count=jnp.asarray(7, jnp.int32), mu=moments[0], nu=moments[1]), *js.opt_state[1:])
    path = tmp_path / "jax.ckpt"
    path.write_bytes(serialization.to_bytes({"params": trees[0], "ema": trees[1], "opt_state": opt_state,
                                             "step": 7}))
    tunet = TUNet(**kw, device="cpu")
    ts = t_state.create_train_state(tunet, t_state.make_optimizer(t_state.cosine_decay_schedule(2e-4, 10, 0.05)),
                                    ema_decay=0.99, device="cpu")
    for load in (lambda: load_flax_train_checkpoint(ts, tunet, path), lambda: t_parity._resume(path, ts, tunet)):
        ts.step = 0
        assert load() in (ts, 7) and ts.step == 7 and int(ts.opt_state["count"]) == 7
        for got, tree in ((ts.params, trees[0]), (ts.ema_params, trees[1]), (ts.opt_state["mu"], moments[0]),
                          (ts.opt_state["nu"], moments[1])):
            want = flax_named(tunet, tree)
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k].numpy(), want[k]), k
