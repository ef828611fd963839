"""The fused ControlNet+UNet encoder towers (``mrisr_torch/models/fused.py``) on the CPU.

The tiny stack of the reference's ``tests/test_fused_towers.py`` (UNet and ControlNet (8, 16, 16, 16), 2
heads, context 16, VAE (8, 8, 16, 16), 64^2 condition, bs 2, 3 steps, every ControlNet weight perturbed so
the residual join carries signal), on numpy-drawn Flax weights: the whole fused ``LatentSRPipeline``
against the unfused one (the condition embedded once a chain and inside every step) within the
reference's own bar, atol 2e-4, rtol 2e-4; the configuration guard and the auto default; weights changed in
place seen by the next chain; and the fused ControlNet and ControlNet+LoRA training steps against the
unfused ones (one SGD step at 1e-2 on JAX's draws: loss rtol 1e-5, parameters atol 1e-5, rtol 1e-4, the
reference's bar).  JAX's fused forms are held to the port's in ``test_torch_latent_pipeline.py``
(the whole chain, 2e-4) and ``test_torch_latent_train.py`` (each step's gradients), whose JAX programs are
compiled there once.  float32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.models import controlnet as j_cn
from mrisr_tpu.models import sd_unet as j_unet
from mrisr_tpu.models import vae as j_vae
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.models import adapter as t_adapter
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import fused as t_fused
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.pipelines import latent as t_latent
from mrisr_torch.train import latent as t_train
from mrisr_torch.train.state import Optimizer, create_train_state
from mrisr_torch.weights import load_flax_params
from test_torch_latent_pipeline import flax_random_params
from test_torch_latent_train import CFG_P, LORA_ALPHA, NET, _cfg_key, _jax_draws, _lora_port, _moments, _towers
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TINY = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
TINY_VAE = (8, 8, 16, 16)
SIZE, BATCH, STEPS = 64, 2, 3
BAR = dict(atol=2e-4, rtol=2e-4)
LR = 1e-2
T_SGD = Optimizer(lambda params: {}, lambda grads, state, params: ({k: -LR * g for k, g in grads.items()}, state))


def _perturbed(tree):
    """The reference test's perturbation: every leaf plus a ramp of 0.01, so the zero convs are not zero."""
    return jax.tree_util.tree_map(lambda a: a + 0.01 * np.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size,
                                  tree)


@pytest.fixture(scope="module")
def stack():
    """The towers' numpy-drawn Flax weights (the ControlNet's perturbed), the LR batch and a chain's draws."""
    lat = SIZE // 8
    x, t, ctx = jnp.zeros((1, lat, lat, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))
    img3 = jnp.zeros((1, SIZE, SIZE, 3))
    junet, jcn, jvae = j_unet.SDUNet(**TINY), j_cn.ControlNet(**TINY), j_vae.AutoencoderKL(block_out_channels=TINY_VAE)
    params = dict(unet=flax_random_params(junet, (x, t, ctx), seed=11),
                  cn=_perturbed(flax_random_params(jcn, (x, t, ctx, img3), seed=12)),
                  vae=flax_random_params(jvae, (img3,), seed=13))
    prompt = np.random.default_rng(14).standard_normal((1, 7, 16)).astype(np.float32)
    lr = np.tanh(np.random.default_rng(15).standard_normal((BATCH, SIZE, SIZE, 1))).astype(np.float32)
    noise = t_latent.ChainNoise.draw((BATCH, 4, lat, lat), STEPS, torch.Generator().manual_seed(16), "cpu")
    return dict(params=params, prompt=prompt, lr=lr, noise=noise)


def _port_towers(stack):
    unet, cn = t_unet.SDUNet(**TINY, device="cpu"), t_cn.ControlNet(**TINY, device="cpu")
    vae = t_vae.AutoencoderKL(TINY_VAE, device="cpu")
    for module, name in ((unet, "unet"), (cn, "cn"), (vae, "vae")):
        load_flax_params(module, stack["params"][name])
    return unet, cn, vae


def _pipe(stack, towers, **kw):
    unet, cn, vae = towers
    return t_latent.LatentSRPipeline(unet, cn, vae, t_sched.sd15_schedule(), torch.from_numpy(stack["prompt"]),
                                     device="cpu", **kw)


def _chain(pipe, stack):
    return pipe.super_resolve(torch.from_numpy(stack["lr"]), num_steps=STEPS, noise=stack["noise"]).numpy()


def test_fused_pipeline_matches_unfused(stack):
    """The fused chain == the unfused chain, with the condition embedded once a chain and inside every step,
    within atol 2e-4, rtol 2e-4."""
    towers = _port_towers(stack)
    fused = _pipe(stack, towers)
    assert fused.fused_towers is True
    got = _chain(fused, stack)
    assert got.shape == (BATCH, SIZE, SIZE, 3) and np.isfinite(got).all()
    for kw in (dict(fused_towers=False), dict(fused_towers=False, precompute_cond=False)):
        np.testing.assert_allclose(got, _chain(_pipe(stack, towers, **kw), stack), **BAR)


def test_fused_towers_need_matching_configs():
    """``check_fusable`` raises ``ValueError`` naming the fused towers, as JAX's does; a forced fused pipeline
    or training step with a mismatched ControlNet raises; the default falls back to the towers one after
    the other, and adapter mode is never fused."""
    unet = t_unet.SDUNet(**TINY, device="cpu")
    cn_bad = t_cn.ControlNet(block_out_channels=(8, 16, 32, 32), heads=2, context_dim=16, device="cpu")
    vae = t_vae.AutoencoderKL(TINY_VAE, device="cpu")
    prompt, sched = torch.zeros((1, 7, 16)), t_sched.sd15_schedule()
    with pytest.raises(ValueError, match="fused towers"):
        t_fused.check_fusable(unet, cn_bad)
    with pytest.raises(ValueError, match="fused towers"):
        t_latent.LatentSRPipeline(unet, cn_bad, vae, sched, prompt, fused_towers=True, device="cpu")
    for make in (t_train.make_controlnet_train_step, t_train.make_cn_lora_train_step):
        with pytest.raises(ValueError, match="fused towers"):
            make(unet, cn_bad, vae, sched, prompt, fused=True, device="cpu")
    assert t_latent.LatentSRPipeline(unet, cn_bad, vae, sched, prompt, device="cpu").fused_towers is False
    cn = t_cn.ControlNet(**TINY, device="cpu")
    assert t_latent.LatentSRPipeline(unet, cn, vae, sched, prompt, device="cpu").fused_towers is True
    assert t_latent.LatentSRPipeline(unet, cn, vae, sched, prompt, fused_towers=False,
                                     device="cpu").fused_towers is False
    ad = t_adapter.T2IAdapter(channels=TINY["block_out_channels"], device="cpu")
    assert t_latent.LatentSRPipeline(unet, None, vae, sched, prompt, adapter=ad, fused_towers=True,
                                     device="cpu").fused_towers is False
    assert [t_fused.resolve_fused(f, unet, c) for f, c in ((None, cn), (None, cn_bad), (False, cn))] == [
        True, False, False]


def test_fused_chain_sees_weights_changed_in_place(stack):
    """The stacked weights are made inside the chain: a UNet encoder weight and a zero conv changed in place
    after construction change the next fused chain, which then equals the unfused chain on the new weights."""
    towers = _port_towers(stack)
    unet, cn, _ = towers
    fused = _pipe(stack, towers)
    before = _chain(fused, stack)
    with torch.no_grad():
        unet.down_blocks_0.resnets_0.conv1.weight.mul_(1.5)
        cn.controlnet_down_blocks_1.weight.add_(0.05)
    after = _chain(fused, stack)
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, _chain(_pipe(stack, towers, fused_towers=False), stack), **BAR)


@pytest.fixture(scope="module")
def towers():
    return _towers(NET, adapter=False)


@pytest.mark.parametrize("mode", ["controlnet", "cn_lora"])
def test_fused_train_step_matches_unfused(mode, towers):
    """One SGD step (1e-2) of the fused ControlNet (or ControlNet+LoRA) step against the unfused one, from
    pixels and from cached latents, on JAX's draws (CFG dropping one of two): loss rtol 1e-5, parameters atol
    1e-5, rtol 1e-4; the step moves most trained tensors (at these widths a GroupNorm group holds one
    channel, so the time embedding's gradient is float noise: ``test_torch_latent_train.py``)."""
    port = towers["port"]
    key, _ = _cfg_key()
    tp, te = torch.from_numpy(towers["prompt"]), torch.from_numpy(towers["empty"])
    tsched = t_sched.sd15_schedule()
    pixels = {k: torch.from_numpy(v) for k, v in towers["batch"].items()}
    cached = {**_moments(port["vae"], towers["batch"]), "lr": pixels["lr"]}
    if mode == "controlnet":
        make = lambda f, c: t_train.make_controlnet_train_step(  # noqa: E731
            port["unet"], port["cn"], port["vae"], tsched, tp, te, CFG_P, fused=f, latents_cached=c, device="cpu")
        start = dict(port["cn"].named_parameters())
    else:
        make = lambda f, c: t_train.make_cn_lora_train_step(  # noqa: E731
            port["unet"], port["cn"], port["vae"], tsched, tp, LORA_ALPHA, te, CFG_P, fused=f, latents_cached=c,
            device="cpu")
        start = t_train.cn_lora_params(port["cn"], _lora_port(towers["lora"]))
    draws = _jax_draws(key)
    for latents_cached, batch in ((False, pixels), (True, cached)):
        got = {}
        for fused in (True, False):
            new, m = make(fused, latents_cached)(create_train_state(start, T_SGD, device="cpu"), batch, None, draws)
            got[fused] = (float(m["loss"]), new.params)
        np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-5)
        assert set(got[True][1]) == set(start)
        for k, p in got[True][1].items():
            np.testing.assert_allclose(p.numpy(), got[False][1][k].numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
        moved = sum(not torch.equal(p, start[k].detach()) for k, p in got[True][1].items())
        assert moved > len(start) / 2, moved
