"""The port's command line and its helpers against the JAX package's, on the CPU.

``python -m mrisr_torch.cli`` trains (train-cnn, train-resdiff), resumes,
builds a slice cache and serves a volume with ``--cpu`` at 32^2 for a few
steps; the config loader, ``_apply_config``'s precedence, ``MetricLogger``'s
records and ``ValidationHook``'s metrics and PNG pixels are held to the JAX
package's.  The JAX CLI itself is not run (its trainers compile for minutes).
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from mrisr_tpu import cli as j_cli
from mrisr_tpu import config as j_config
from mrisr_tpu.train import validation as j_validation
from mrisr_tpu.utils import logging as j_logging
from mrisr_torch import cli as t_cli
from mrisr_torch import config as t_config
from mrisr_torch.data.nifti import read_nifti, write_nifti
from mrisr_torch.data.slicecache import SliceCacheDataset
from mrisr_torch.train import validation as t_validation
from mrisr_torch.utils import logging as t_logging
from mrisr_torch.utils import profiling as t_profiling
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parents[1]
TRAIN = ["--cpu", "--resolution", "32", "--batch", "2"]


def _ckpt(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# The CLI on the CPU
# ---------------------------------------------------------------------------


def test_train_resdiff_resumes_bitwise_and_sr_volume_serves_its_checkpoint(tmp_path, capsys):
    """3 steps in one run equal 2 steps and a ``--resume`` to 3 (parameters, EMA, optimizer state: bitwise);
    the resumed run validates at step 3 (metrics and a PNG strip per validation image); its ``run_`` record
    counts each batch made and waited for and no graph on the CPU; ``sr-volume`` serves the checkpoint's EMA
    weights and prints its chain's counts (an eager CPU chain: no capture, no replay, no stage times)."""
    a, b = tmp_path / "a", tmp_path / "b"
    t_cli.main(["train-resdiff", *TRAIN, "--steps", "3", "--out", str(a)])
    t_cli.main(["train-resdiff", *TRAIN, "--steps", "2", "--out", str(b)])
    t_cli.main(["train-resdiff", *TRAIN, "--steps", "3", "--resume", "--val-every", "3", "--val-steps", "2",
                "--out", str(b)])
    want, got = _ckpt(a / "ckpt" / "step_3.pt"), _ckpt(b / "ckpt" / "step_3.pt")
    assert got["step"] == 3
    _assert_trees_equal(got, want)
    records = [json.loads(line) for line in (b / "metrics.jsonl").read_text().splitlines()]
    assert any("val_psnr" in r and r["step"] == 3 for r in records)
    run = [r for r in records if "run_steps_per_s" in r]
    assert [r["run_steps"] for r in run] == [2.0, 1.0] and all(r["run_steps_per_s"] > 0 for r in run)
    for r in run:
        assert r["run_data_make_ms_per_batch"] > 0 and r["run_data_wait_ms_per_batch"] >= 0
        assert r["run_graph_captures"] == r["run_graph_replays"] == 0 and 0 <= r["run_loader_starved"] <= r["run_steps"]
        assert not any(k.startswith("run_stage_ms_") for k in r)
    assert sorted(p.name for p in (b / "val").iterdir()) == [f"val_{i:02d}.png" for i in range(4)]

    rng = np.random.default_rng(3)
    vol = (rng.random((30, 26, 3)) * 900).astype(np.float32)
    write_nifti(tmp_path / "vol.nii", vol, np.diag([1.0, 1.0, 2.0, 1.0]))
    out = t_cli.run(["sr-volume", "--cpu", "--resolution", "32", "--batch", "2", "--ddim-steps", "2",
                     "--checkpoint", str(b / "ckpt"), "--input", str(tmp_path / "vol.nii"),
                     "--output", str(tmp_path / "sr.nii")])
    served = read_nifti(tmp_path / "sr.nii").data
    assert served.shape == vol.shape and np.isfinite(served).all()
    assert capsys.readouterr().out.splitlines()[-1] == "chain captures=0 replays=0"
    ema = out["pipeline"].unet.state_dict()
    for name, p in got["ema_params"].items():
        assert torch.equal(ema[name], p), name
    np.testing.assert_array_equal(served, out["volume"].data)


def test_train_cnn_build_cache_and_train_resdiff_from_the_cache(tmp_path):
    """``build-cache`` writes the phantom set into a slice cache; ``train-cnn --cache`` trains on it and
    validates; ``train-resdiff --cache --cnn-checkpoint`` restores that CNN and trains with bf16 compute and
    gradient accumulation."""
    cache = tmp_path / "phantom.slc"
    t_cli.main(["build-cache", "--cpu", "--resolution", "32", "--out", str(cache)])
    ds = SliceCacheDataset(cache)
    phantom = t_cli.Phantom(res=32)
    assert len(ds) == len(phantom) == 64
    np.testing.assert_array_equal(ds[5]["hr"], phantom[5]["hr"])
    np.testing.assert_array_equal(ds[5]["lr"], phantom[5]["lr"])
    cnn_out = tmp_path / "cnn"
    res = t_cli.run(["train-cnn", *TRAIN, "--steps", "3", "--val-every", "3", "--cache", str(cache),
                     "--out", str(cnn_out)])
    assert res["state"].step == 3 and (cnn_out / "val" / "val_00.png").exists()
    res = t_cli.run(["train-resdiff", *TRAIN, "--steps", "2", "--cache", str(cache), "--cnn-checkpoint",
                     str(cnn_out / "ckpt"), "--precision", "bfloat16", "--grad-accum", "2",
                     "--out", str(tmp_path / "rd")])
    state = res["state"]
    assert state.step == 2 and int(state.opt_state["gradient_step"]) == 1
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in state.params.values())


def test_cli_help_lists_the_ported_commands():
    out = subprocess.run([sys.executable, "-m", "mrisr_torch.cli", "--help"], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    for cmd in ("train-mnist", "train-cnn", "train-resdiff", "train-latent", "build-cache", "sr-volume",
                "convert-weights", "preprocess-slices", "export-png", "evaluate", "build-index", "stats", "report",
                "parity", "parity-latent", "bench"):  # all 16 of the reference's
        assert cmd in out
    assert set(t_cli.build_parser()[1]) == {
        "train-mnist", "train-cnn", "train-resdiff", "train-latent", "build-cache", "sr-volume", "convert-weights",
        "preprocess-slices", "export-png", "evaluate", "build-index", "stats", "report", "parity", "parity-latent",
        "bench"}


# ---------------------------------------------------------------------------
# Config, logging, profiling, validation
# ---------------------------------------------------------------------------


def test_config_loading_and_precedence_match_jax(tmp_path):
    """YAML (with the float resolver) and JSON configs load to the reference's values and flatten alike;
    ``_apply_config`` fills only the flags left at their defaults, with the values the file set."""
    yaml_text = "optim:\n  lr: 1e-3\ntrain:\n  max_steps: 77\n  seed: 5\ndata:\n  batch_size: 3\nfoo: 1\n"
    (tmp_path / "c.yaml").write_text(yaml_text)
    (tmp_path / "c.json").write_text(json.dumps({"train": {"max_steps": 9, "mixed_precision": "float32"},
                                                 "data": {"resolution": 64}}))
    for name in ("c.yaml", "c.json"):
        got, want = t_config.load_config(tmp_path / name), j_config.load_config(tmp_path / name)
        assert t_config.config_to_flat_dict(got) == j_config.config_to_flat_dict(want)
    assert t_config.load_config(tmp_path / "c.yaml").optim.lr == 1e-3
    ap, subparsers = t_cli.build_parser()
    for argv in (["train-resdiff", "--config", str(tmp_path / "c.yaml")],
                 ["train-resdiff", "--config", str(tmp_path / "c.yaml"), "--steps", "12", "--batch", "4"],
                 ["train-cnn", "--config", str(tmp_path / "c.json"), "--resolution", "128"]):
        args = ap.parse_args(argv)
        want = j_cli._apply_config(copy.deepcopy(args), subparsers[args.cmd])
        got = t_cli._apply_config(args, subparsers[args.cmd])
        assert vars(got) == vars(want)
    args = t_cli._apply_config(ap.parse_args(argv[:3]), subparsers["train-cnn"])
    assert (args.steps, args.resolution, args.precision) == (9, 64, "float32")


def test_metric_logger_and_profiling(tmp_path):
    """The same ``metrics.jsonl`` records as the reference's (``ts`` aside); ``timed`` and ``trace`` on the
    CPU."""
    metrics = {"loss": 0.25, "lr": np.float32(1e-4), "tag": "x"}
    for logger, out in ((t_logging.MetricLogger(tmp_path / "t"), "t"), (j_logging.MetricLogger(tmp_path / "j"), "j")):
        logger.log(3, {**metrics, "loss_t": torch.tensor(0.5) if out == "t" else jnp.asarray(0.5)})
        logger.log(4, {"val_psnr": 30.0}, prefix="run_")
        logger.finish()
    strip = lambda path: [{k: v for k, v in json.loads(line).items() if k != "ts"}  # noqa: E731
                          for line in path.read_text().splitlines()]
    assert strip(tmp_path / "t" / "metrics.jsonl") == strip(tmp_path / "j" / "metrics.jsonl")
    out, sec = t_profiling.timed(lambda x: x * 2, torch.ones(4), warmup=1, repeats=2)
    assert torch.equal(out, torch.full((4,), 2.0)) and sec >= 0
    with t_profiling.trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()


def test_validation_hook_metrics_and_png_pixels_match_jax(tmp_path):
    """The same metrics (rtol 1e-5) from the same samples, and PNG strips whose decoded pixels equal the
    reference's (PIL writes the reference's, the port writes its own)."""
    from PIL import Image

    rng = np.random.default_rng(4)
    batch = {"lr": rng.random((3, 24, 20, 1), np.float32), "hr": rng.random((3, 24, 20, 1), np.float32)}
    sr = np.clip(batch["hr"] + 0.05 * rng.standard_normal(batch["hr"].shape).astype(np.float32), 0, 1)
    for unit in (True, False):
        t_hook = t_validation.ValidationHook(lambda p, lr, g: torch.from_numpy(sr), batch, tmp_path / f"t{unit}",
                                             every=2, max_strips=2, data_in_unit_range=unit)
        j_hook = j_validation.ValidationHook(lambda p, lr, k: jnp.asarray(sr), batch, tmp_path / f"j{unit}",
                                             every=2, max_strips=2, data_in_unit_range=unit)
        assert t_hook.maybe_run(3, None, None) is None and t_hook.maybe_run(0, None, None) is None
        got, want = t_hook.maybe_run(4, None, None), j_hook.run(None, None)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        for i in range(2):
            a = np.asarray(Image.open(tmp_path / f"t{unit}" / f"val_{i:02d}.png"))
            b = np.asarray(Image.open(tmp_path / f"j{unit}" / f"val_{i:02d}.png"))
            assert a.shape == (24, 60) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        assert not (tmp_path / f"t{unit}" / "val_02.png").exists()
