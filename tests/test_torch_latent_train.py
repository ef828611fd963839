"""The port's latent training steps (``mrisr_torch/train/latent.py``) and ``train-latent`` on the CPU.

Each factory takes one step from the same weights (numpy-drawn Flax trees,
carried across with ``load_flax_params``) and the same draws (those the JAX
step makes from its key, handed to the port as ``draws``) in both packages,
at the smallest widths both take: UNet and ControlNet (8, 16), one layer a
block, 2 heads, context 16; VAE (8, 8, 16, 16); 32^2 pixels, batch 2.  Both
train with an optimizer that moves nothing and keeps the step's gradients as
its state (an ``optax.GradientTransformation``; a hand-made ``Optimizer`` in
the port), so the gradients are compared as they are, not as ``p - g`` minus
``p`` (which rounds them to the spacing of ``p``).  Every JAX step is
compiled once.  float32.

The bars: the loss (and the VAE's reconstruction and KL terms) within rtol
1e-4; each parameter tensor's gradient within 1e-3 of that tensor's largest
|gradient| (the two packages sum the convolutions' gradients in different
orders).  At these widths every GroupNorm has one channel a group, so a bias
ahead of one (and what feeds only such biases: ``time_emb_proj``, the time
embedding) has a gradient that is zero in exact arithmetic and float noise
(below 1e-7 of the step's largest) in both packages: a tensor whose largest
|gradient| is below 1e-6 of the step's largest is held within 1e-6 of the
step's largest instead, and fewer than half the tensors may be such.  So the
ControlNet and ControlNet+LoRA steps are also taken at widths (64, 128),
where a group holds 2 and 4 channels: the timestep reaches the output there,
and the time embedding's gradients are held to JAX's like every other.  The
port-only checks (cached latents, the K-step wrappers, the optimizer and
checkpoint over flat LoRA names, the command line) are bitwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu.diffusion import schedules as j_sched
from mrisr_tpu.models import adapter as j_adapter
from mrisr_tpu.models import controlnet as j_cn
from mrisr_tpu.models import convert as j_convert
from mrisr_tpu.models import lora as j_lora
from mrisr_tpu.models import sd_unet as j_unet
from mrisr_tpu.models import vae as j_vae
from mrisr_tpu.train import latent as j_latent
from mrisr_tpu.train.state import create_train_state as j_create_state
from mrisr_torch import cli as t_cli
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.models import adapter as t_adapter
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.train import latent as t_latent
from mrisr_torch.train.state import Optimizer, create_train_state, make_optimizer
from mrisr_torch.train.steps import _nchw as t_nchw
from mrisr_torch.train.steps import step_generator
from mrisr_torch.utils.checkpoint import CheckpointManager
from mrisr_torch.weights import load_flax_params, load_params_npz
from test_torch_cli import _assert_trees_equal, _ckpt
from test_torch_latent_pipeline import flax_random_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

NET = dict(block_out_channels=(8, 16), layers_per_block=1, heads=2, context_dim=16)
# 2 and 4 channels a GroupNorm group (``gn_groups``: 32 groups where the width allows, else gcd with 32)
WIDE = dict(NET, block_out_channels=(64, 128))
VAE = (8, 8, 16, 16)
SIZE, BATCH, LAT, CTX = 32, 2, 4, (7, 16)
LORA_RANK, LORA_ALPHA, CFG_P = 2, 2.0, 0.5
LOSS_RTOL, GRAD_RTOL, ZERO_GRAD = 1e-4, 1e-3, 1e-6
SGD = Optimizer(lambda params: {}, lambda grads, state, params: ({k: -g for k, g in grads.items()}, state))
# Optimizers that move nothing and keep the step's gradients as their state (the gradients compared).
J_RECORD = optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
T_RECORD = Optimizer(lambda params: {},
                     lambda grads, state, params: ({k: torch.zeros_like(g) for k, g in grads.items()}, dict(grads)))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _port(cls, tree, *args, **kw):
    """A port module on the CPU with the Flax tree's weights."""
    module = cls(*args, **kw, device="cpu")
    load_flax_params(module, tree)
    return module


def _towers(net, adapter: bool = True) -> dict:
    """Both packages' modules at widths ``net``, one set of numpy-drawn weights, the batch and prompts."""
    x, t, ctx = jnp.zeros((1, LAT, LAT, 4)), jnp.array([1]), jnp.zeros((1, *CTX))
    img3 = jnp.zeros((1, SIZE, SIZE, 3))
    j = dict(unet=j_unet.SDUNet(**net), cn=j_cn.ControlNet(**net), vae=j_vae.AutoencoderKL(block_out_channels=VAE))
    params = dict(unet=flax_random_params(j["unet"], (x, t, ctx), seed=1),
                  cn=flax_random_params(j["cn"], (x, t, ctx, img3), seed=2),
                  vae=flax_random_params(j["vae"], (img3,), seed=3))
    rng = np.random.default_rng(5)
    # LoRA factors with a random b, so both factors get gradients
    paths = j_lora.init_lora_params(jax.random.PRNGKey(0), params["unet"], rank=LORA_RANK)
    lora = {path: {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in ab.items()}
            for path, ab in paths.items()}
    batch = {k: rng.uniform(0.0, 1.0, (BATCH, SIZE, SIZE, 1)).astype(np.float32) for k in ("hr", "lr")}
    prompt = (0.5 * rng.standard_normal((1, *CTX))).astype(np.float32)
    empty = (0.5 * rng.standard_normal((1, *CTX))).astype(np.float32)
    port = dict(unet=_port(t_unet.SDUNet, params["unet"], **net), cn=_port(t_cn.ControlNet, params["cn"], **net),
                vae=_port(t_vae.AutoencoderKL, params["vae"], VAE))
    if adapter:
        j["adapter"] = j_adapter.T2IAdapter(channels=net["block_out_channels"])
        params["adapter"] = flax_random_params(j["adapter"], (img3,), seed=4)
        port["adapter"] = _port(t_adapter.T2IAdapter, params["adapter"], channels=net["block_out_channels"])
    return dict(net=net, j=j, params=params, lora=lora, batch=batch, prompt=prompt, empty=empty, port=port)


@pytest.fixture(scope="module")
def towers():
    return _towers(NET)


@pytest.fixture(scope="module")
def wide():
    """The ControlNet and LoRA towers at ``WIDE``."""
    return _towers(WIDE, adapter=False)


def _cfg_key():
    """A key whose CFG mask (``bernoulli(p=0.5)`` over the batch, from its fourth split) drops one of two."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        drop = np.asarray(jax.random.bernoulli(jax.random.split(key, 4)[3], CFG_P, (BATCH,)))
        if drop.sum() == 1:
            return key, drop
    raise AssertionError("no key drops one of two")


def _jax_draws(key):
    """The draws of a JAX latent step from ``key`` (``train/latent.py``: four splits; t and eps from the
    third), in the port's layout."""
    k_hr, k_lr, k_diff, k_cfg = jax.random.split(key, 4)
    k_t, k_eps = jax.random.split(k_diff)
    shape = (BATCH, LAT, LAT, 4)
    return {"hr_noise": _nchw(jax.random.normal(k_hr, shape)), "lr_noise": _nchw(jax.random.normal(k_lr, shape)),
            "t": torch.from_numpy(np.asarray(jax.random.randint(k_t, (BATCH,), 0, 1000), np.int64)),
            "eps": _nchw(jax.random.normal(k_eps, shape)),
            "drop": torch.from_numpy(np.array(jax.random.bernoulli(k_cfg, CFG_P, (BATCH,))))}


def _port_names(cls, tree, *args, **kw) -> dict[str, torch.Tensor]:
    """A Flax tree of parameter-shaped arrays (weights or gradients) under the port module's names."""
    return {k: v.detach() for k, v in _port(cls, tree, *args, **kw).named_parameters()}


def _lora_port(lora: dict) -> dict:
    return {path[1:]: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()} for path, ab in lora.items()}


def _assert_grads(got: dict, want: dict):
    """Each tensor within ``GRAD_RTOL`` of its own largest |gradient|; a tensor whose gradient is zero in
    exact arithmetic (largest |gradient| below ``ZERO_GRAD`` of the step's largest) within ``ZERO_GRAD`` of the
    step's largest."""
    assert set(got) == set(want) and got
    want = {k: torch.as_tensor(w) for k, w in want.items()}
    top = max(float(w.abs().max()) for w in want.values())
    zero = 0
    for name, w in want.items():
        scale = float(w.abs().max())
        zero += scale < ZERO_GRAD * top
        err = float((got[name] - w).abs().max())
        assert err <= max(GRAD_RTOL * scale, ZERO_GRAD * top), (name, err, scale, top)
    assert zero < len(want) / 2


def test_vae_step_matches_jax(towers):
    """``make_vae_train_step``: reconstruction + 1e-6 KL, the posterior noise drawn from JAX's key."""
    j, params, batch = towers["j"], towers["params"], towers["batch"]
    key = jax.random.PRNGKey(7)
    jstate = j_create_state(None, params["vae"], J_RECORD)
    jnew, jm = j_latent.make_vae_train_step(j["vae"])(jstate, {"img": jnp.asarray(batch["hr"])}, key)
    noise = _nchw(jax.random.normal(key, (BATCH, LAT, LAT, 4)))
    vae = towers["port"]["vae"]
    state = create_train_state(vae, T_RECORD, device="cpu")
    step = t_latent.make_vae_train_step(vae, device="cpu")
    new, m = step(state, {"img": torch.from_numpy(batch["hr"])}, None, {"noise": noise})
    for k in ("loss", "rec", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
    _assert_grads(new.opt_state, _port_names(t_vae.AutoencoderKL, jnew.opt_state, VAE))


MODES = ("base_sample", "controlnet", "lora", "adapter", "cn_lora")


def _steps(towers, mode):
    """(JAX step, JAX trained params, port step, port state, port names of a JAX gradient tree)."""
    j, params, port, net = towers["j"], towers["params"], towers["port"], towers["net"]
    jsched, tsched = j_sched.sd15_schedule(), t_sched.sd15_schedule()
    jp, je = jnp.asarray(towers["prompt"]), jnp.asarray(towers["empty"])
    tp, te = torch.from_numpy(towers["prompt"]), torch.from_numpy(towers["empty"])
    common = dict(empty_embeds=te, proportion_empty_prompts=CFG_P, device="cpu")
    lora_t = _lora_port(towers["lora"])
    cn_names = lambda tree: _port_names(t_cn.ControlNet, tree, **net)  # noqa: E731
    lora_names = lambda tree, prefix="": t_latent.lora_params(_lora_port(tree), prefix)  # noqa: E731
    if mode == "base_sample":
        jstep = j_latent.make_latent_base_train_step(j["unet"], j["vae"], jsched, jp, je, CFG_P, "sample")
        tstep = t_latent.make_latent_base_train_step(port["unet"], port["vae"], tsched, tp, prediction_type="sample",
                                                     **common)
        return (jstep, params["unet"], tstep, create_train_state(port["unet"], T_RECORD, device="cpu"),
                lambda tree: _port_names(t_unet.SDUNet, tree, **net))
    if mode == "controlnet":
        jstep = j_latent.make_controlnet_train_step(j["unet"], j["cn"], j["vae"], jsched, jp, je, CFG_P, fused=True)
        tstep = t_latent.make_controlnet_train_step(port["unet"], port["cn"], port["vae"], tsched, tp, **common)
        return jstep, params["cn"], tstep, create_train_state(port["cn"], T_RECORD, device="cpu"), cn_names
    if mode == "lora":
        jstep = j_latent.make_lora_train_step(j["unet"], j["vae"], jsched, jp, params["unet"], LORA_ALPHA, je, CFG_P)
        tstep = t_latent.make_lora_train_step(port["unet"], port["vae"], tsched, tp, LORA_ALPHA, **common)
        state = create_train_state(t_latent.lora_params(lora_t), T_RECORD, device="cpu")
        return jstep, towers["lora"], tstep, state, lora_names
    if mode == "adapter":
        jstep = j_latent.make_adapter_train_step(j["unet"], j["adapter"], j["vae"], jsched, jp, je, CFG_P)
        tstep = t_latent.make_adapter_train_step(port["unet"], port["adapter"], port["vae"], tsched, tp, **common)
        return (jstep, params["adapter"], tstep, create_train_state(port["adapter"], T_RECORD, device="cpu"),
                lambda tree: _port_names(t_adapter.T2IAdapter, tree, channels=net["block_out_channels"]))
    jstep = j_latent.make_cn_lora_train_step(j["unet"], j["cn"], j["vae"], jsched, jp, params["unet"], LORA_ALPHA, je,
                                             CFG_P, fused=True)
    tstep = t_latent.make_cn_lora_train_step(port["unet"], port["cn"], port["vae"], tsched, tp, LORA_ALPHA, **common)
    state = create_train_state(t_latent.cn_lora_params(port["cn"], lora_t), T_RECORD, device="cpu")
    names = lambda tree: {**{f"cn/{k}": v for k, v in cn_names(tree["cn"]).items()},  # noqa: E731
                          **lora_names(tree["lora"], "lora/")}
    return jstep, {"cn": params["cn"], "lora": towers["lora"]}, tstep, state, names


def _step_matches_jax(towers, mode) -> dict:
    """One step of ``mode`` in both packages, its loss and gradients held to JAX's: -> the port's gradients."""
    jstep, jparams, tstep, state, names = _steps(towers, mode)
    key, drop = _cfg_key()
    frozen = {"unet": towers["params"]["unet"], "vae": towers["params"]["vae"]}
    jbatch = {k: jnp.asarray(v) for k, v in towers["batch"].items()}
    jnew, jm = jstep(j_create_state(None, jparams, J_RECORD), frozen, jbatch, key)
    draws = _jax_draws(key)
    assert draws["drop"].tolist() == drop.tolist() and drop.sum() == 1
    tbatch = {k: torch.from_numpy(v) for k, v in towers["batch"].items()}
    new, m = tstep(state, tbatch, None, draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    assert new.step == 1
    _assert_grads(new.opt_state, names(jnew.opt_state))
    return new.opt_state


@pytest.mark.parametrize("mode", MODES)
def test_latent_step_matches_jax(mode, towers):
    """One step of each latent factory (the base UNet with ``prediction_type="sample"``), CFG dropout at p=0.5
    with a key whose mask drops one of the two samples; the ControlNet towers fused in both (each package's
    default form)."""
    _step_matches_jax(towers, mode)


@pytest.mark.parametrize("mode", ("controlnet", "cn_lora"))
def test_latent_step_matches_jax_where_the_timestep_counts(mode, wide):
    """The ControlNet and ControlNet+LoRA steps at ``WIDE``, where no GroupNorm cancels the time embedding's
    shift: as in ``test_latent_step_matches_jax``, and the ControlNet's time embedding (and each
    ``time_emb_proj``) gets gradients well above float noise, so a wrong ``t`` or time-embedding path would
    show in the comparison."""
    grads = _step_matches_jax(wide, mode)
    top = max(float(g.abs().max()) for g in grads.values())
    timed = {k: float(g.abs().max()) for k, g in grads.items() if "time_emb" in k and k.endswith("weight")}
    assert timed and min(timed.values()) > 1e-3 * top, timed


def _moments(vae, batch) -> dict:
    """The cached-latent batch keys of ``batch``: the VAE posterior's moments, NHWC."""
    out = {}
    with torch.no_grad():
        for side in ("hr", "lr"):
            x = t_nchw(torch.from_numpy(batch[side])).expand(-1, 3, -1, -1)
            mean, logvar = vae.encode_moments(x)
            out[f"{side}_mean"], out[f"{side}_logvar"] = (t.permute(0, 2, 3, 1).contiguous() for t in (mean, logvar))
    return out


def test_cached_latents_equal_the_pixel_path(towers):
    """Cached moments and the pixel path give the same step at equal noise (one generator seed: the same draws
    in the same order), bitwise, for the ControlNet and the LoRA factory."""
    port, batch = towers["port"], towers["batch"]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cached = {**_moments(port["vae"], batch), "lr": tbatch["lr"]}
    tp, te = torch.from_numpy(towers["prompt"]), torch.from_numpy(towers["empty"])
    sched = t_sched.sd15_schedule()
    for make, state in ((lambda c: t_latent.make_controlnet_train_step(
            port["unet"], port["cn"], port["vae"], sched, tp, te, CFG_P, latents_cached=c, device="cpu"),
            create_train_state(port["cn"], SGD, device="cpu")),
            (lambda c: t_latent.make_lora_train_step(
                port["unet"], port["vae"], sched, tp, LORA_ALPHA, te, CFG_P, latents_cached=c, device="cpu"),
             create_train_state(t_latent.lora_params(_lora_port(towers["lora"])), SGD, device="cpu"))):
        a, ma = make(False)(state, tbatch, torch.Generator().manual_seed(3))
        b, mb = make(True)(state, cached, torch.Generator().manual_seed(3))
        assert torch.equal(ma["loss"], mb["loss"])
        assert all(torch.equal(a.params[k], b.params[k]) for k in state.params)


def test_many_wrappers_equal_their_loops(towers):
    """Each K-step wrapper equals its loop of steps, batch ``i`` row ``idx[i]`` and generator
    ``step_generator(seed, step_ids[i])`` (AdamW, clipped: the CLI's optimizer)."""
    port, batch = towers["port"], towers["batch"]
    tp, te = torch.from_numpy(towers["prompt"]), torch.from_numpy(towers["empty"])
    sched = t_sched.sd15_schedule()
    tx = make_optimizer(1e-3, kind="adamw", max_grad_norm=1.0)
    rng = np.random.default_rng(9)
    pool = {k: torch.from_numpy(rng.uniform(0, 1, (4, SIZE, SIZE, 1)).astype(np.float32)) for k in ("hr", "lr")}
    cached = {**_moments(port["vae"], {k: v.numpy() for k, v in pool.items()}), "lr": pool["lr"]}
    idx, step_ids, seed = torch.tensor([[0, 2], [3, 1]]), [5, 8], 11
    lora_state = create_train_state(t_latent.lora_params(_lora_port(towers["lora"])), tx, device="cpu")
    lora_step = t_latent.make_lora_train_step(port["unet"], port["vae"], sched, tp, LORA_ALPHA, te, CFG_P,
                                              device="cpu")
    cn_step = t_latent.make_controlnet_train_step(port["unet"], port["cn"], port["vae"], sched, tp, te, CFG_P,
                                                  latents_cached=True, device="cpu")
    vae_step = t_latent.make_vae_train_step(port["vae"], device="cpu")
    cases = (
        (t_latent.make_latent_train_many(lora_step), lora_step, lora_state, (pool["lr"], pool["hr"]), pool,
         lambda m: m["loss"]),
        (t_latent.make_latent_train_many_cached(cn_step), cn_step, create_train_state(port["cn"], tx, device="cpu"),
         (cached,), cached, lambda m: m["loss"]),
        (t_latent.make_vae_train_many(vae_step), vae_step, create_train_state(port["vae"], tx, device="cpu"),
         (pool["hr"],), {"img": pool["hr"]}, lambda m: torch.stack([m["loss"], m["rec"], m["kl"]])))
    for many, step, state, args, data, row in cases:
        got, rows = many(state, *args, idx, step_ids, seed)
        want, want_rows = state, []
        for ix, sid in zip(idx, step_ids):
            want, m = step(want, {k: v[ix] for k, v in data.items()}, step_generator(seed, sid, "cpu"))
            want_rows.append(row(m))
        assert torch.equal(rows, torch.stack(want_rows)) and got.step == want.step == 2
        _assert_trees_equal(got.state_dict(), want.state_dict())


def test_flat_lora_states_accumulate_clip_and_checkpoint(towers, tmp_path):
    """The LoRA and ControlNet+LoRA states (flat names) under ``make_optimizer("adamw", max_grad_norm=1.0,
    grad_accum=2)``: nothing moves on the first micro-step, everything on the second; a checkpoint restores
    them bitwise; ``lora_tree`` inverts ``lora_params``."""
    port, batch = towers["port"], towers["batch"]
    tp, te = torch.from_numpy(towers["prompt"]), torch.from_numpy(towers["empty"])
    sched = t_sched.sd15_schedule()
    lora = _lora_port(towers["lora"])
    flat = t_latent.lora_params(lora, "lora/")
    assert t_latent.lora_tree(flat, "lora/").keys() == lora.keys()
    tx = make_optimizer(1e-3, kind="adamw", max_grad_norm=1.0, grad_accum=2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name, state, step in (
            ("lora", create_train_state(t_latent.lora_params(lora), tx, device="cpu"),
             t_latent.make_lora_train_step(port["unet"], port["vae"], sched, tp, LORA_ALPHA, te, CFG_P, device="cpu")),
            ("cn_lora", create_train_state(t_latent.cn_lora_params(port["cn"], lora), tx, device="cpu"),
             t_latent.make_cn_lora_train_step(port["unet"], port["cn"], port["vae"], sched, tp, LORA_ALPHA, te, CFG_P,
                                              device="cpu"))):
        one, _ = step(state, tbatch, step_generator(1, 0, "cpu"))
        assert all(torch.equal(one.params[k], p) for k, p in state.params.items())
        two, _ = step(one, tbatch, step_generator(1, 1, "cpu"))
        assert all(not torch.equal(two.params[k], p) for k, p in state.params.items()), name
        assert int(two.opt_state["gradient_step"]) == 1
        mgr = CheckpointManager(tmp_path / name)
        mgr.save(two.step, two)
        _assert_trees_equal(mgr.restore(state).state_dict(), two.state_dict())


TINY = ["--cpu", "--tiny", "--resolution", "64", "--batch", "2"]


@pytest.mark.parametrize("mode", ["controlnet", "lora", "adapter"])
def test_train_latent_cli_resumes_bitwise(mode, tmp_path):
    """``train-latent --cpu --tiny``: 3 steps in one run equal 2 steps and a ``--resume`` to 3 (parameters and
    AdamW state, bitwise)."""
    a, b = tmp_path / "a", tmp_path / "b"
    res = t_cli.run(["train-latent", *TINY, "--mode", mode, "--steps", "3", "--out", str(a)])
    t_cli.main(["train-latent", *TINY, "--mode", mode, "--steps", "2", "--out", str(b)])
    t_cli.main(["train-latent", *TINY, "--mode", mode, "--steps", "3", "--resume", "--out", str(b)])
    want, got = _ckpt(a / "ckpt" / "step_3.pt"), _ckpt(b / "ckpt" / "step_3.pt")
    assert got["step"] == res["state"].step == 3
    _assert_trees_equal(got, want)
    assert all(torch.isfinite(p).all() for p in got["params"].values())


def test_train_latent_reads_converted_weights(towers, tmp_path):
    """``--weights-dir``: a ``vae.npz`` as the JAX package's ``save_params_npz`` writes it is read into the
    trainer's VAE (the tiny VAE has the test's widths)."""
    j_convert.save_params_npz(tmp_path / "vae.npz", towers["params"]["vae"])
    tree = load_params_npz(tmp_path / "vae.npz")
    want = j_convert.load_params_npz(tmp_path / "vae.npz")
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    res = t_cli.run(["train-latent", *TINY, "--steps", "1", "--weights-dir", str(tmp_path), "--out",
                     str(tmp_path / "run")])
    got = dict(res["vae"].named_parameters())
    for name, p in towers["port"]["vae"].named_parameters():
        assert torch.equal(got[name], p), name


def test_chip_smoke_counts_the_latent_training_launches(monkeypatch):
    """``chip_smoke.py::latent_train_expect`` (the launches the card's graphs are held to) is what a step
    calls: each B1, B2 (dQ and dK/dV) and B3 call of an eager CPU step is counted, with the dense-attention
    limit lowered so that the tiny towers' level-0 self-attentions (64 keys) take the flash route; with the
    towers one after the other and fused (the default, whose down-tower sites take both lanes)."""
    from mrisr_torch.models import fused as fused_towers
    from mrisr_torch.models import sd_layers
    from mrisr_torch.ops import attention
    from mrisr_torch.ops import flash_attention as fa
    from test_torch_ops import _chip_smoke

    smoke = _chip_smoke()
    monkeypatch.setattr(sd_layers, "DENSE_MAX_KEYS", 32)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 0)
    calls = dict.fromkeys(("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                           "group_norm_silu"), 0)

    def counted(fn, *names):
        def wrapper(*args, **kw):
            for name in names:
                calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(fa, "flash_attention_fwd", counted(fa.flash_attention_fwd, "flash_attention_fwd"))
    monkeypatch.setattr(fa, "flash_attention_bwd", counted(fa.flash_attention_bwd, "flash_attention_bwd_dq",
                                                           "flash_attention_bwd_dkv"))
    monkeypatch.setattr(sd_layers, "group_norm_silu", counted(sd_layers.group_norm_silu, "group_norm_silu"))
    monkeypatch.setattr(fused_towers, "group_norm_silu", counted(fused_towers.group_norm_silu, "group_norm_silu"))
    torch.manual_seed(0)
    cfg = t_cli.LATENT_TINY
    unet, cn = t_unet.SDUNet(**cfg["unet"], device="cpu"), t_cn.ControlNet(**cfg["unet"], device="cpu")
    vae = t_vae.AutoencoderKL(**cfg["vae"], device="cpu")
    prompt = torch.randn((1, *cfg["context"]))
    for mode, cached in (("cn_lora", False), ("controlnet", True)):
        for fused in (False, True):
            expect = smoke.latent_train_expect(unet, cn, vae, mode, 64, cached, fused)
            data = smoke.latent_train_batch(torch, 1, 64, 1, vae if cached else None, device="cpu")
            state, step = smoke.latent_train_step(torch, unet, cn, vae, mode, cached, prompt,
                                                  torch.zeros_like(prompt), device="cpu", cuda_graph=False,
                                                  fused=fused)
            calls.update(dict.fromkeys(calls, 0))
            step(state, data, step_generator(2, 0, "cpu"))
            assert calls == expect and expect["flash_attention_fwd"] == (5 if fused else 7), (mode, calls, expect)
            assert expect["flash_attention_bwd_dq"] == (5 if fused else 7 if mode == "cn_lora" else 5)
