"""The port's whole ``LatentSRPipeline`` against the JAX package's, on the CPU.

ControlNet and T2I-Adapter mode at the JAX bench's ``cpu_smoke`` sizes (64^2
condition, block widths (8, 16, 16, 16), 2 heads, context 16; VAE (8, 8, 16,
16)), 3 steps; the JAX key's draws (VAE posterior, start, each step) are
reproduced from its splits and handed to the port.  float32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.diffusion import schedules as j_sched
from mrisr_tpu.models import adapter as j_adapter
from mrisr_tpu.models import controlnet as j_cn
from mrisr_tpu.models import sd_unet as j_unet
from mrisr_tpu.models import vae as j_vae
from mrisr_tpu.pipelines import latent as j_latent
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.models import adapter as t_adapter
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.pipelines import latent as t_latent
from mrisr_torch.weights import load_flax_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TINY = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
TINY_VAE = (8, 8, 16, 16)
TINY_ADAPTER = (8, 16, 16, 16)


def flax_random_params(module, args, seed=0, **kw):
    """Kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases and embeddings ~ 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("bias", "embedding", "position_embedding"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(int(np.prod(s.shape[:-1])))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _x(*shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# The draws of the JAX chain
# ---------------------------------------------------------------------------


def _jax_chain_noise(key, shape, steps, start_dtype=jnp.float32):
    """The draws ``mrisr_tpu.pipelines.sampler.res_shift_sample`` makes from ``key`` (NHWC ``shape``):
    the start (in the anchor's dtype, ``start_dtype``) from the second half of the first split, then one
    float32 split per step; float32 arrays."""
    key, k0 = jax.random.split(key)
    start = np.asarray(jax.random.normal(k0, shape, start_dtype), np.float32)
    step = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        step.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return start, np.stack(step)


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------

PIPE_SIZE, PIPE_BATCH, PIPE_STEPS = 64, 2, 3


@pytest.fixture(scope="module")
def tiny_towers():
    """The JAX UNet, ControlNet and VAE at the tiny widths with their numpy-drawn UNet and VAE parameters,
    shared by both modes (their trees take seconds to trace)."""
    lat = PIPE_SIZE // 8
    x, t, ctx = jnp.zeros((1, lat, lat, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))
    img3 = jnp.zeros((1, PIPE_SIZE, PIPE_SIZE, 3))
    junet, jcn, jvae = j_unet.SDUNet(**TINY), j_cn.ControlNet(**TINY), j_vae.AutoencoderKL(block_out_channels=TINY_VAE)
    return dict(lat=lat, args=(x, t, ctx), img3=img3, junet=junet, jcn=jcn, jvae=jvae,
                unet_params=flax_random_params(junet, (x, t, ctx), seed=1),
                vae_params=flax_random_params(jvae, (img3,), seed=3))


@pytest.mark.parametrize("mode", ["controlnet", "adapter"])
def test_latent_pipeline_matches_jax(mode, tiny_towers):
    """``LatentSRPipeline.super_resolve`` against JAX's at 3 steps, the JAX key's draws (VAE posterior,
    start, each step) handed to the port.  JAX runs its default form (the fused towers in ControlNet
    mode).  The bar on the ``[B, H, W, 3]`` output: atol 1e-3, rtol 1e-3."""
    lat, (x, t, ctx), img3 = tiny_towers["lat"], tiny_towers["args"], tiny_towers["img3"]
    junet, jcn, jvae = (tiny_towers[k] for k in ("junet", "jcn", "jvae"))
    unet_params, vae_params = tiny_towers["unet_params"], tiny_towers["vae_params"]
    prompt = _x(1, 7, 16, seed=4)
    lr = np.tanh(_x(PIPE_BATCH, PIPE_SIZE, PIPE_SIZE, 1, seed=5))
    tunet, tvae = t_unet.SDUNet(**TINY, device="cpu"), t_vae.AutoencoderKL(TINY_VAE, device="cpu")
    load_flax_params(tunet, unet_params)
    load_flax_params(tvae, vae_params)
    if mode == "adapter":
        jad = j_adapter.T2IAdapter(channels=TINY_ADAPTER)
        side_params = flax_random_params(jad, (img3,), seed=2)
        tad = t_adapter.T2IAdapter(channels=TINY_ADAPTER, device="cpu")
        load_flax_params(tad, side_params)
        jpipe_kw, tpipe = dict(adapter=jad), t_latent.LatentSRPipeline(
            tunet, None, tvae, t_sched.sd15_schedule(), torch.from_numpy(prompt), adapter=tad, device="cpu")
    else:
        side_params = flax_random_params(jcn, (x, t, ctx, img3), seed=2)
        tcn = t_cn.ControlNet(**TINY, device="cpu")
        load_flax_params(tcn, side_params)
        jpipe_kw, tpipe = {}, t_latent.LatentSRPipeline(
            tunet, tcn, tvae, t_sched.sd15_schedule(), torch.from_numpy(prompt), device="cpu")
    jpipe = j_latent.LatentSRPipeline(junet, jcn, jvae, j_sched.sd15_schedule(), unet_params, side_params,
                                      vae_params, jnp.asarray(prompt), **jpipe_kw)
    assert jpipe.fused_towers == (mode == "controlnet")
    key = jax.random.PRNGKey(21)
    want = np.asarray(jpipe.super_resolve(jnp.asarray(lr), key, num_inference_steps=PIPE_STEPS))

    # the draws of _super_resolve_impl (latent.py:163) and res_shift_sample (sampler.py:161, :169)
    key, k_enc = jax.random.split(key)
    shape = (PIPE_BATCH, lat, lat, 4)
    vae_noise = np.asarray(jax.random.normal(k_enc, shape, jnp.float32))
    start, step = _jax_chain_noise(key, shape, PIPE_STEPS)
    noise = t_latent.ChainNoise(nchw(vae_noise), nchw(start),
                                torch.from_numpy(np.ascontiguousarray(step.transpose(0, 1, 4, 2, 3))))
    got = tpipe.super_resolve(torch.from_numpy(lr), num_inference_steps=PIPE_STEPS, noise=noise)
    assert tuple(got.shape) == (PIPE_BATCH, PIPE_SIZE, PIPE_SIZE, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)

    # drawn from a generator: posterior, start, then the steps
    a = tpipe.super_resolve(torch.from_numpy(lr), torch.Generator().manual_seed(9), PIPE_STEPS)
    drawn = t_latent.ChainNoise.draw(tpipe.latent_shape(torch.from_numpy(lr)), PIPE_STEPS,
                                     torch.Generator().manual_seed(9), "cpu")
    assert torch.equal(a, tpipe.super_resolve(torch.from_numpy(lr), num_inference_steps=PIPE_STEPS, noise=drawn))
    many = tpipe.super_resolve_group(torch.from_numpy(lr)[None], [torch.Generator().manual_seed(9)], PIPE_STEPS)
    assert torch.equal(many[0], a)
    vis = t_latent.decode_to_vis(got)
    np.testing.assert_array_equal(vis, j_latent.decode_to_vis(jnp.asarray(got.numpy())))


def test_prepare_condition_image():
    img = np.tanh(_x(2, 40, 48, 1, seed=6))
    for hw in ((40, 48), (64, 64)):
        want = np.asarray(j_latent.prepare_condition_image(jnp.asarray(img), hw))
        got = t_latent.prepare_condition_image(torch.from_numpy(img), hw)
        assert tuple(got.shape) == (2, *hw, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# A bf16 chain: the reference's dtype flow
# ---------------------------------------------------------------------------

BF16_NET = dict(block_out_channels=(8, 16), layers_per_block=1, heads=2, context_dim=16)


def test_bf16_latent_chain_follows_the_reference_dtypes(tiny_towers):
    """A bf16 ControlNet chain (bf16 weights, LR and prompt) against JAX's, 3 steps, the JAX key's draws
    handed over (its posterior and start noise are bf16 draws, upcast exactly).  As in the reference, the
    VAE encoder, the condition embedding and the prompt's projections run in bf16; the start state and every
    carry after it are fp32, so the UNet, ControlNet and decoder compute in fp32 against bf16-rounded
    weights, and the output is fp32.  A two-level UNet (the tiny widths) keeps the JAX compile short.

    The bf16 parts round differently in the two packages (XLA keeps excess precision inside a fusion; each
    torch op rounds), which leaves 3.7e-3 of rms(ref) / 1.6e-2 max on the output.  The bar: rms error
    <= 8e-3 of rms(ref), max error <= 3e-2.  A bf16 carry (every step in bf16) gives 1.26e-2 / 4.5e-2."""
    lat = PIPE_SIZE // 8
    x, t, ctx = jnp.zeros((1, lat, lat, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))
    img3 = jnp.zeros((1, PIPE_SIZE, PIPE_SIZE, 3))
    junet, jcn = j_unet.SDUNet(**BF16_NET), j_cn.ControlNet(**BF16_NET)
    jvae, vae_params = tiny_towers["jvae"], tiny_towers["vae_params"]
    bf16 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)  # noqa: E731
    unet_params = flax_random_params(junet, (x, t, ctx), seed=31)
    cn_params = flax_random_params(jcn, (x, t, ctx, img3), seed=32)
    prompt = jnp.asarray(_x(1, 7, 16, seed=34), jnp.bfloat16)
    lr = jnp.asarray(np.tanh(_x(PIPE_BATCH, PIPE_SIZE, PIPE_SIZE, 1, seed=35)), jnp.bfloat16)
    jpipe = j_latent.LatentSRPipeline(junet, jcn, jvae, j_sched.sd15_schedule(), bf16(unet_params),
                                      bf16(cn_params), bf16(vae_params), prompt, fused_towers=False)
    key = jax.random.PRNGKey(22)
    want = jpipe.super_resolve(lr, key, num_inference_steps=PIPE_STEPS)
    assert want.dtype == jnp.float32

    modules = []
    for cls, params in ((t_unet.SDUNet, unet_params), (t_cn.ControlNet, cn_params)):
        mod = cls(**BF16_NET, device="cpu")
        load_flax_params(mod, params)
        modules.append(mod.to(torch.bfloat16))
    tvae = t_vae.AutoencoderKL(TINY_VAE, device="cpu")
    load_flax_params(tvae, vae_params)
    tpipe = t_latent.LatentSRPipeline(*modules, tvae.to(torch.bfloat16), t_sched.sd15_schedule(),
                                      torch.from_numpy(np.asarray(prompt, np.float32)).bfloat16(), device="cpu")
    # the draws of _super_resolve_impl and res_shift_sample: posterior and start in the anchor's dtype (bf16)
    key, k_enc = jax.random.split(key)
    shape = (PIPE_BATCH, lat, lat, 4)
    vae_noise = np.asarray(jax.random.normal(k_enc, shape, jnp.bfloat16), np.float32)
    start, step = _jax_chain_noise(key, shape, PIPE_STEPS, jnp.bfloat16)
    noise = t_latent.ChainNoise(nchw(vae_noise), nchw(start),
                                torch.from_numpy(np.ascontiguousarray(step.transpose(0, 1, 4, 2, 3))))
    seen = {}
    hooks = [mod.register_forward_pre_hook(lambda m, args, name=name: seen.update({name: args[0].dtype}))
             for name, mod in (("encoder", tvae.encoder.conv_in), ("decoder", tvae.decoder.conv_in),
                               ("unet", modules[0].conv_in), ("controlnet", modules[1].conv_in),
                               ("condition", modules[1].controlnet_cond_embedding.conv_in))]
    got = tpipe.super_resolve(torch.from_numpy(np.asarray(lr, np.float32)).bfloat16(),
                              num_inference_steps=PIPE_STEPS, noise=noise)
    for h in hooks:
        h.remove()
    assert seen == {"encoder": torch.bfloat16, "condition": torch.bfloat16, "unet": torch.float32,
                    "controlnet": torch.float32, "decoder": torch.float32}
    assert got.dtype == torch.float32
    err, ref = got.numpy() - np.asarray(want), np.asarray(want)
    assert np.sqrt(np.mean(err**2)) <= 8e-3 * np.sqrt(np.mean(ref**2)) and np.abs(err).max() <= 3e-2
