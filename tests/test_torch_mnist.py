"""The port's MNIST family and adafactor against the JAX package, on the CPU.

``MNISTUNet`` (both modes, with and without labels) from Flax weights
carried across by ``load_flax_params``; the regression and DDPM steps from
one state with JAX's draws handed over; the IDX readers, the synthetic
digits and ``MNISTSRDataset``; ``run_mnist``; ``train-mnist`` on the CPU
(metrics keys against JAX's CLI, ``--resume`` bitwise); ``adafactor``,
``multi_transform`` and the cosine decay against optax.
"""
from __future__ import annotations

import gzip
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu.data import datasets as j_data
from mrisr_tpu.diffusion.schedules import mnist_schedule as j_mnist_schedule
from mrisr_tpu.eval import parity as j_parity
from mrisr_tpu.models.mnist_unet import MNISTUNet as JMNIST
from mrisr_tpu.train import state as j_state
from mrisr_tpu.train import steps as j_steps
from mrisr_torch import cli as t_cli
from mrisr_torch.data import datasets as t_data
from mrisr_torch.diffusion.schedules import mnist_schedule as t_mnist_schedule
from mrisr_torch.eval import parity as t_parity
from mrisr_torch.models.mnist_unet import MNISTUNet as TMNIST
from mrisr_torch.train import state as t_state
from mrisr_torch.train import steps as t_steps
from mrisr_torch.weights import flax_named, load_flax_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from test_torch_resdiff import flax_random_params, to_torch
from test_torch_train import _assert_params_track, _flat

B = 4
LR = 1e-3


def _tensors(state):
    return [t for t in _flat(state) if t is not None]


def _x(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init_args(in_ch):
    return (jnp.zeros((1, 28, 28, in_ch)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))


@pytest.fixture(scope="module")
def models():
    """JAX MNISTUNets (10 classes) with numpy-drawn parameters for 1 and 2 input channels, and their ports."""
    out = {}
    for in_ch in (1, 2):
        jm = JMNIST(num_classes=10)
        params = flax_random_params(jm, _init_args(in_ch), seed=10 + in_ch)
        tm = TMNIST(num_classes=10, in_channels=in_ch, device="cpu")
        load_flax_params(tm, params)
        out[in_ch] = (jm, params, tm)
    return out


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["regression", "ddpm", "ddpm_labels"])
def test_mnist_unet_forward_matches_flax(models, mode):
    """Regression (no t, no y: no embedding), DDPM with t, and with t and labels: atol 2e-4, rtol 1e-3."""
    in_ch = 1 if mode == "regression" else 2
    jm, params, tm = models[in_ch]
    x = _x(B, 28, 28, in_ch, seed=20)
    t = np.array([0, 17, 500, 999], np.int32) if mode != "regression" else None
    y = np.array([3, 0, 9, 5], np.int32) if mode == "ddpm_labels" else None
    want = np.asarray(jm.apply(params, jnp.asarray(x), None if t is None else jnp.asarray(t),
                               None if y is None else jnp.asarray(y)))
    tm.eval()
    with torch.no_grad():
        got = tm(to_torch(x), None if t is None else torch.from_numpy(t), None if y is None else torch.from_numpy(y))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-4, rtol=1e-3)


def test_mnist_unet_names_and_heads():
    """Every Flax leaf of ``MNISTUNet`` fills one parameter (``weights.flax_named``), and every GroupNorm ->
    swish, the final one included, goes through ``group_norm_silu``: 15 calls a forward."""
    jm = JMNIST(num_classes=10)
    params = flax_random_params(jm, _init_args(2), seed=3)
    tm = TMNIST(num_classes=10, in_channels=2, device="cpu")
    assert set(flax_named(tm, params)) == {n for n, _ in tm.named_parameters()}
    from mrisr_torch.models import layers, mnist_unet

    calls = []
    real = layers.group_norm_silu

    def spy(x, *a):
        calls.append(tuple(x.shape))
        return real(x, *a)

    layers.group_norm_silu = mnist_unet.group_norm_silu = spy
    try:
        tm(torch.zeros(2, 2, 28, 28), torch.tensor([1, 2]))
    finally:
        layers.group_norm_silu = mnist_unet.group_norm_silu = real
    assert len(calls) == 15 and calls[-1] == (2, 32, 28, 28)


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def _batch(seed):
    hr = np.tanh(_x(B, 28, 28, 1, seed=seed))
    lr_up = np.tanh(_x(B, 28, 28, 1, seed=seed + 1))
    return hr, lr_up, np.array([1, 4, 7, 2], np.int32)


def test_mnist_regression_steps_match_jax(models):
    """Two regression steps (Adam 1e-3) from one state: losses rtol 1e-4, parameters as
    ``test_torch_train`` holds the ResDiff step.  The time MLP, the class embedding and each block's Dense get
    zero gradients (the loss does not reach them) and stay where they were, as under optax."""
    jm, params, tm0 = models[1]
    js = j_state.create_train_state(jm.apply, params, j_state.make_optimizer(LR))
    j_step = j_steps.make_mnist_regression_step(jm)
    tm = TMNIST(num_classes=10, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    t_step = t_steps.make_mnist_regression_step(tm, device="cpu")
    ts = t_state.create_train_state(tm, t_state.make_optimizer(LR), device="cpu")
    before = {k: v.clone() for k, v in ts.params.items()}
    for i in range(2):
        hr, lr_up, label = _batch(30 + 2 * i)
        js, jm_ = j_step(js, {"hr": jnp.asarray(hr), "lr_up": jnp.asarray(lr_up), "label": jnp.asarray(label)},
                         jax.random.PRNGKey(i))
        ts, tm_ = t_step(ts, {"hr": torch.from_numpy(hr), "lr_up": torch.from_numpy(lr_up),
                              "label": torch.from_numpy(label)})
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-4, err_msg=f"step {i}")
    want = {k: v for k, v in flax_named(tm, js.params).items()}
    n = sum(p.numel() for p in ts.params.values())
    _assert_params_track(ts.params, want, LR, 2, loose_max=n // 1000)
    unused = [k for k in ts.params if k.startswith(("Dense_0", "Embed_0")) or ".Dense_0" in k]
    assert len(unused) == 2 + 1 + 2 * 7
    for k in unused:
        assert torch.equal(ts.params[k], before[k]), k


def test_mnist_ddpm_steps_match_jax(models):
    """Two conditional DDPM steps, JAX's ``t`` and ``eps`` (``steps.py``: ``k_t, k_eps = split(key)``)
    handed over: losses rtol 1e-4, parameters as ``test_torch_train`` holds the ResDiff step."""
    jm, params, tm0 = models[2]
    sj = j_mnist_schedule(1000)
    js = j_state.create_train_state(jm.apply, params, j_state.make_optimizer(LR))
    j_step = j_steps.make_mnist_ddpm_step(jm, sj)
    tm = TMNIST(num_classes=10, in_channels=2, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    t_step = t_steps.make_mnist_ddpm_step(tm, t_mnist_schedule(1000), device="cpu")
    ts = t_state.create_train_state(tm, t_state.make_optimizer(LR), device="cpu")
    for i in range(2):
        hr, lr_up, label = _batch(40 + 2 * i)
        key = jax.random.PRNGKey(100 + i)
        k_t, k_eps = jax.random.split(key)
        t = np.asarray(jax.random.randint(k_t, (B,), 0, sj.num_timesteps))
        eps = np.asarray(jax.random.normal(k_eps, hr.shape, jnp.float32))
        js, jm_ = j_step(js, {"hr": jnp.asarray(hr), "lr_up": jnp.asarray(lr_up), "label": jnp.asarray(label)}, key)
        ts, tm_ = t_step(ts, {"hr": torch.from_numpy(hr), "lr_up": torch.from_numpy(lr_up),
                              "label": torch.from_numpy(label)}, None,
                         {"t": torch.from_numpy(t.copy()), "eps": to_torch(eps)})
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-4, err_msg=f"step {i}")
    n = sum(p.numel() for p in ts.params.values())
    _assert_params_track(ts.params, flax_named(tm, js.params), LR, 2, loose_max=n // 1000)


def test_mnist_ddpm_step_draws_t_then_eps_from_its_generator():
    """Without ``draws`` the step draws ``t`` (``randint(0, T)``) and then ``eps`` from the generator: handing
    those same draws over gives the same state."""
    tm = TMNIST(num_classes=10, in_channels=2, device="cpu")
    sched = t_mnist_schedule(1000)
    step = t_steps.make_mnist_ddpm_step(tm, sched, device="cpu")
    hr, lr_up, label = _batch(50)
    batch = {"hr": torch.from_numpy(hr), "lr_up": torch.from_numpy(lr_up), "label": torch.from_numpy(label)}
    s0 = t_state.create_train_state(tm, t_state.make_optimizer(LR), device="cpu")
    a, _ = step(s0, batch, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    t = torch.randint(0, 1000, (B,), generator=g)
    eps = torch.randn((B, 1, 28, 28), generator=g)
    b, _ = step(s0, batch, None, {"t": t, "eps": eps})
    for x, y in zip(_tensors(a), _tensors(b), strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The data
# ---------------------------------------------------------------------------


def _write_idx(path, images, labels, gz):
    img = struct.pack(">4i", 2051, *images.shape) + images.tobytes()
    lbl = struct.pack(">2i", 2049, len(labels)) + labels.tobytes()
    suffix = "-ubyte.gz" if gz else "-ubyte"
    for name, raw in ((f"t10k-images-idx3{suffix}", img), (f"t10k-labels-idx1{suffix}", lbl)):
        (path / name).write_bytes(gzip.compress(raw) if gz else raw)


@pytest.mark.parametrize("gz", [False, True])
def test_idx_readers_and_dataset_match_jax(tmp_path, gz):
    """The IDX readers bitwise (plain and gzipped), ``MNISTSRDataset`` over them: HR and labels bitwise, the
    14^2 LR within 1e-6 (the resize bar of ``test_torch_data``); a bad magic raises."""
    images = np.random.default_rng(5).integers(0, 256, (6, 28, 28), dtype=np.uint8)
    labels = np.random.default_rng(6).integers(0, 10, 6).astype(np.uint8)
    _write_idx(tmp_path, images, labels, gz)
    suffix = "-ubyte.gz" if gz else "-ubyte"
    for reader in ("_read_idx_images", "_read_idx_labels"):
        name = "t10k-images-idx3" if "images" in reader else "t10k-labels-idx1"
        got = getattr(t_data, reader)(tmp_path / f"{name}{suffix}")
        want = getattr(j_data, reader)(tmp_path / f"{name}{suffix}")
        assert got.dtype == want.dtype and np.array_equal(got, want)
    tds, jds = t_data.MNISTSRDataset(tmp_path, mode="test"), j_data.MNISTSRDataset(tmp_path, mode="test")
    assert len(tds) == len(jds) == 6
    for i in range(6):
        a, b = tds[i], jds[i]
        assert np.array_equal(a["hr"], b["hr"]) and a["label"] == b["label"]
        np.testing.assert_allclose(a["lr"], b["lr"], atol=1e-6)
    (tmp_path / "bad").write_bytes(struct.pack(">4i", 1234, 1, 28, 28) + bytes(784))
    with pytest.raises(ValueError, match="magic"):
        t_data._read_idx_images(tmp_path / "bad")


def test_synthetic_digits_and_dataset_match_jax():
    """``synthetic_digits`` bitwise (images and labels), and the synthetic ``MNISTSRDataset`` items."""
    for seed in (0, 1):
        ti, tl = t_data.synthetic_digits(40, seed)
        ji, jl = j_data.synthetic_digits(40, seed)
        assert np.array_equal(ti, ji) and np.array_equal(tl, jl) and tl.dtype == jl.dtype
    tds, jds = t_data.MNISTSRDataset(None, n_synthetic=16), j_data.MNISTSRDataset(None, n_synthetic=16)
    for i in (0, 7, 15):
        a, b = tds[i], jds[i]
        assert a["hr"].shape == (28, 28, 1) and a["lr"].shape == (14, 14, 1)
        assert np.array_equal(a["hr"], b["hr"]) and a["label"] == b["label"]
        np.testing.assert_allclose(a["lr"], b["lr"], atol=1e-6)


# ---------------------------------------------------------------------------
# The harness's MNIST leg and the command line
# ---------------------------------------------------------------------------


def test_run_mnist_matches_jax():
    """``run_mnist`` from JAX's initial weights (``PRNGKey(0)``), 3 steps of bs 8: the same report keys, and
    the metrics of the trained model and of the bicubic baseline within 1e-3 dB / 1e-4 (the regression draws
    nothing random, so the runs differ only in float sums)."""
    jm = JMNIST(num_classes=10)
    init = jm.init(jax.random.PRNGKey(0), *_init_args(1))
    want = j_parity.run_mnist(steps=3, batch=8)
    tm = TMNIST(num_classes=10, device="cpu")
    params = {k: torch.from_numpy(np.array(v)) for k, v in flax_named(tm, init).items()}
    got = t_parity.run_mnist(steps=3, batch=8, device="cpu", params=params)
    assert set(got) == set(want) and got["steps"] == want["steps"] == 3
    for part in ("model", "bicubic_baseline"):
        assert set(got[part]) == set(want[part])
        assert abs(got[part]["psnr"] - want[part]["psnr"]) < 1e-3, part
        for m in ("ssim", "nmse", "hfen"):
            assert abs(got[part][m] - want[part][m]) < 1e-4, (part, m)


def _metric_lines(path):
    return [json.loads(x) for x in open(path) if '"loss"' in x]


@pytest.mark.parametrize("mode", ["regression", "ddpm"])
def test_train_mnist_cli_logs_the_references_keys_and_resumes_bitwise(tmp_path, mode):
    """``train-mnist --cpu`` for 3 steps logs its loss lines with the keys JAX's command logs (every 50
    steps: step 0); 2 steps and ``--resume`` to 3 equal 3 uninterrupted steps bitwise."""
    from mrisr_tpu import cli as j_cli

    flags = ["--cpu", "--mode", mode, "--batch", "4"]
    j_cli.main(["train-mnist", *flags, "--steps", "1", "--out", str(tmp_path / "jax")])
    whole = t_cli.run(["train-mnist", *flags, "--steps", "3", "--out", str(tmp_path / "whole")])
    want = _metric_lines(tmp_path / "jax" / "metrics.jsonl")
    got = _metric_lines(tmp_path / "whole" / "metrics.jsonl")
    assert [set(x) for x in got] == [set(x) for x in want] and [x["step"] for x in got] == [0]
    t_cli.run(["train-mnist", *flags, "--steps", "2", "--out", str(tmp_path / "part")])
    resumed = t_cli.run(["train-mnist", *flags, "--steps", "3", "--resume", "--out", str(tmp_path / "part")])
    assert resumed["state"].step == whole["state"].step == 3
    for a, b in zip(_tensors(resumed["state"]), _tensors(whole["state"]), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# adafactor, multi_transform and the cosine decay against optax
# ---------------------------------------------------------------------------

# name -> (optax layout, port layout as a permutation of it or None); both dims >= 128 factor.
ADA_SHAPES = {
    "matrix": ((256, 130), None),
    "tie": ((128, 128), None),
    "vector": ((300,), None),
    "conv": ((3, 3, 128, 256), (3, 2, 0, 1)),  # Flax HWIO -> the port's OIHW
    "conv_1x1_tie": ((1, 1, 128, 128), (3, 2, 0, 1)),
    "small": ((3, 3, 8, 16), (3, 2, 0, 1)),  # never factored (second largest dim < 128)
    "unused": ((140, 129), None),  # always a zero gradient
}
ADA_CASES = {"plain": {}, "composed": dict(max_grad_norm=1.0, skip_nonfinite=True, grad_accum=2)}


@pytest.mark.parametrize("case", sorted(ADA_CASES))
def test_adafactor_matches_optax(case):
    """``make_optimizer(kind="adafactor")`` (a cosine-decay schedule) against ``optax.adafactor`` over six
    calls: every parameter within 1e-6 relative, the conv weights in the port's layout against optax's in
    Flax's (the factored estimate is symmetric in its two dims), the unused parameter left where it was;
    ``composed`` wraps it in the global-norm clip, the non-finite skip (a NaN gradient on call 3) and
    two-step accumulation, as ``make_optimizer`` does in both packages."""
    kw = ADA_CASES[case]
    lr_j = optax.cosine_decay_schedule(1e-2, 4, alpha=0.05)
    lr_t = t_state.cosine_decay_schedule(1e-2, 4, alpha=0.05)
    rng = np.random.default_rng(7)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in ADA_SHAPES.items()}

    def port(k, a):
        perm = ADA_SHAPES[k][1]
        return a if perm is None else a.transpose(perm)

    tx_j = j_state.make_optimizer(lr_j, kind="adafactor", **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx_j.init(jp)
    tx_t = t_state.make_optimizer(lr_t, kind="adafactor", **kw)
    tp = {k: torch.from_numpy(np.array(port(k, v))) for k, v in p0.items()}
    ts = tx_t.init(tp)
    for call in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in ADA_SHAPES.items()}
        g["unused"][:] = 0.0
        if case == "composed" and call == 2:
            g["vector"][5] = np.nan
        updates, js = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        tx_t.update_({k: torch.from_numpy(np.ascontiguousarray(port(k, v))) for k, v in g.items()}, ts, tp)
        for k in ADA_SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), port(k, np.asarray(jp[k])), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} call {call}")
    assert np.array_equal(tp["unused"].numpy(), p0["unused"])
    assert not np.array_equal(tp["matrix"].numpy(), p0["matrix"])


def test_adafactor_factors_as_optax_and_keeps_its_tensors():
    """The moments' shapes follow optax's choice of dims on the port's layout; ``update_`` changes every
    tensor where it lies (what a CUDA graph needs), and the count is a 0-d int64 tensor."""
    tx = t_state.make_optimizer(1e-2, kind="adafactor")
    params = {"m": torch.randn(256, 130), "v": torch.randn(300), "c": torch.randn(256, 128, 3, 3)}
    st = tx.init(params)
    assert set(st["v"]) == {"v"} and set(st["v_row"]) == set(st["v_col"]) == {"m", "c"}
    # optax: (d1, d0) = the second largest and the largest dim; v_row drops d0, v_col drops d1.
    assert tuple(st["v_row"]["m"].shape) == (130,) and tuple(st["v_col"]["m"].shape) == (256,)
    assert tuple(st["v_row"]["c"].shape) == (128, 3, 3) and tuple(st["v_col"]["c"].shape) == (256, 3, 3)
    ptrs = [t.data_ptr() for t in (*params.values(), *st["v"].values(), *st["v_row"].values())]
    tx.update_({k: torch.randn_like(v) for k, v in params.items()}, st, params)
    assert [t.data_ptr() for t in (*params.values(), *st["v"].values(), *st["v_row"].values())] == ptrs
    assert st["count"].dtype == torch.int64 and st["count"].ndim == 0 and int(st["count"]) == 1


def test_multi_transform_matches_optax():
    """Two labels with their own Adam learning rates (the ControlNet+LoRA leg's optimizer), three calls."""
    rng = np.random.default_rng(9)
    p0 = {"cn/w": rng.standard_normal((5, 3)).astype(np.float32), "lora/a": rng.standard_normal(4).astype(np.float32)}
    jtx = optax.multi_transform({"cn": optax.adam(2e-4), "lora": optax.adam(1e-3)},
                                {"cn": {"w": "cn"}, "lora": {"a": "lora"}})
    jp = {"cn": {"w": jnp.asarray(p0["cn/w"])}, "lora": {"a": jnp.asarray(p0["lora/a"])}}
    js = jtx.init(jp)
    ttx = t_state.multi_transform({"cn": t_state.make_optimizer(2e-4), "lora": t_state.make_optimizer(1e-3)},
                                  lambda name: name.split("/", 1)[0])
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = ttx.init(tp)
    for call in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        u, js = jtx.update({"cn": {"w": jnp.asarray(g["cn/w"])}, "lora": {"a": jnp.asarray(g["lora/a"])}}, js, jp)
        jp = optax.apply_updates(jp, u)
        ttx.update_({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    np.testing.assert_allclose(tp["cn/w"].numpy(), np.asarray(jp["cn"]["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["lora/a"].numpy(), np.asarray(jp["lora"]["a"]), rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError):
        t_state.multi_transform({"cn": t_state.make_optimizer()}, lambda n: n.split("/")[0]).init(tp)


@pytest.mark.parametrize("steps", [1, 7])
def test_cosine_decay_schedule_matches_optax(steps):
    """The harness's ``cosine_decay_schedule(2e-4, steps, alpha=0.05)`` at and after ``steps``, on the host
    and from a 0-d count tensor (how a graphed optimizer reads it)."""
    want = optax.cosine_decay_schedule(2e-4, steps, alpha=0.05)
    got = t_state.cosine_decay_schedule(2e-4, steps, alpha=0.05)
    for count in (0, 1, 3, steps - 1, steps, steps + 1, 5 * steps + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=f"count {count}")
        np.testing.assert_allclose(float(got(torch.tensor(count))), float(want(count)), rtol=1e-6)
    with pytest.raises(ValueError):
        t_state.cosine_decay_schedule(1e-3, 0)
