"""The port's samplers and ResDiffPipeline against the JAX reference, on the CPU.

A tiny configuration (32^2, inner 8, GroupNorm(4)) with Flax parameters drawn
from numpy and carried across.  The JAX pipeline draws its starting noise in
the space-to-depth shape when that form is eligible; the port takes the same
draw, brought back to ``[B, H, W, 1]``, as its explicit ``x_T``.  With eta 0
the rest of the chain draws no noise, so the two chains must agree.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.diffusion.schedules import resdiff_schedule as j_resdiff_schedule
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_tpu.models.simple_cnn import SimpleCNN as JCNN
from mrisr_tpu.ops.space_to_depth import depth_to_space
from mrisr_tpu.pipelines import sampler as j_sampler
from mrisr_tpu.pipelines.resdiff import ResDiffPipeline as JPipeline
from mrisr_torch.diffusion.schedules import resdiff_schedule
from mrisr_torch.models.resdiff_unet import ResDiffUNet as TUNet
from mrisr_torch.models.simple_cnn import SimpleCNN as TCNN
from mrisr_torch.pipelines import sampler as t_sampler
from mrisr_torch.pipelines.resdiff import ResDiffPipeline
from mrisr_torch.weights import load_flax_params
from test_torch_resdiff import flax_random_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SIZE = 32
TINY = dict(image_size=SIZE, inner_channel=8, norm_groups=4)


def _lr(b, seed=0):
    """A smooth bounded slice in [-1, 1], standing in for an LR MRI slice."""
    base = np.random.default_rng(seed).standard_normal((b, SIZE, SIZE, 1))
    k = np.ones(5) / 5.0
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 2, base)
    return np.tanh(2.0 * sm).astype(np.float32)


@pytest.fixture(scope="module")
def pipelines():
    jcnn, junet = JCNN(), JUNet(**TINY, dropout=0.0)
    cnn_p = flax_random_params(jcnn, (jnp.zeros((1, SIZE, SIZE, 1)),), seed=10)
    unet_p = flax_random_params(junet, (jnp.zeros((1, SIZE, SIZE, 2)), jnp.array([0.5])), seed=11)
    jpipe = JPipeline(jcnn, junet, j_resdiff_schedule(1000), cnn_p, unet_p)
    tcnn, tunet = TCNN(device="cpu"), TUNet(**TINY, device="cpu")
    load_flax_params(tcnn, cnn_p)
    load_flax_params(tunet, unet_p)
    tpipe = ResDiffPipeline(tcnn, tunet, resdiff_schedule(1000), device="cpu")
    return jpipe, tpipe


def test_stage1_matches(pipelines):
    jpipe, tpipe = pipelines
    lr = _lr(2)
    want = np.asarray(jpipe.stage1(jnp.asarray(lr)))
    got = tpipe.stage1(torch.from_numpy(lr))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_four_step_chain_matches_jax(pipelines):
    """``super_resolve`` over 4 trailing DDIM steps, same x_T, fp32.

    Tolerance: the North-star forward bar (atol 2e-4, rtol 1e-3) on the SR
    output after four chained UNet evaluations.
    """
    jpipe, tpipe = pipelines
    lr = _lr(2, seed=1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpipe.super_resolve(jnp.asarray(lr), key, num_steps=4))
    # The JAX pipeline's first draw: key, k0 = split(key); x_T in the s2d shape.
    assert jpipe.unet.s2d_eligible(SIZE, SIZE)
    _, k0 = jax.random.split(key)
    x_T = depth_to_space(jax.random.normal(k0, (2, SIZE // 2, SIZE // 2, 4), jnp.float32))
    got = tpipe.super_resolve(torch.from_numpy(lr), x_T=torch.from_numpy(np.array(x_T)), num_steps=4)
    assert got.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_many_and_group_run_one_chain_per_entry(pipelines):
    _, tpipe = pipelines
    lr = torch.from_numpy(np.stack([_lr(1, seed=4), _lr(1, seed=5)]))  # [G=2, B=1, H, W, 1]
    out = tpipe.super_resolve_group(lr, torch.Generator().manual_seed(7), num_steps=2)
    assert out.shape == (2, 1, SIZE, SIZE, 1) and torch.isfinite(out).all()
    gen = torch.Generator().manual_seed(7)
    for g in range(2):
        one = tpipe.super_resolve(lr[g], gen, num_steps=2)
        torch.testing.assert_close(out[g], one, atol=0, rtol=0)
    with pytest.raises(ValueError):
        tpipe.super_resolve(lr[0], x_T=torch.zeros(1, SIZE, SIZE, 2), num_steps=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_inputs_stay_nchw_contiguous(monkeypatch, dtype):
    """On the card the GN+SiLU kernel takes only NCHW-contiguous input.

    A channels-last tensor (what a transpose+reshape or a permute of a
    [B, H, W, 1] input leaves behind) is carried on by the convolutions, so
    every ConvBlock head of the chain is checked here on the CPU.
    """
    from mrisr_torch.models import layers

    seen = []
    plain = layers.group_norm_silu

    def spy(x, *args, **kw):
        seen.append(x.is_contiguous())
        return plain(x, *args, **kw)

    monkeypatch.setattr(layers, "group_norm_silu", spy)
    tunet = TUNet(**TINY, device="cpu").to(dtype)
    pipe = ResDiffPipeline(TCNN(device="cpu").to(dtype), tunet, resdiff_schedule(1000), device="cpu")
    lr = torch.from_numpy(_lr(2)).to(dtype)
    pipe.super_resolve(lr, torch.Generator().manual_seed(0), num_steps=1)
    assert len(seen) == 29 and all(seen)


def test_ddim_sample_matches_with_integer_t():
    """The integer-t DDIM sampler with a closed-form eps_fn, eta 0."""
    x_T = np.random.default_rng(8).standard_normal((2, 4, 4, 1)).astype(np.float32)

    def eps_j(x, t):
        return 0.3 * x + 1e-3 * t[:, None, None, None].astype(jnp.float32)

    def eps_t(x, t):
        return 0.3 * x + 1e-3 * t[:, None, None, None].float()

    want = j_sampler.ddim_sample(j_resdiff_schedule(1000), eps_j, jnp.asarray(x_T),
                                 jax.random.PRNGKey(0), num_steps=10)
    got = t_sampler.ddim_sample(resdiff_schedule(1000), eps_t, torch.from_numpy(x_T), num_steps=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    # num_steps=None: the full-length ancestral chain (1000 steps), fed the
    # reference's own per-step noise (its key split once a step).
    key = jax.random.PRNGKey(1)

    def split(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, x_T.shape, jnp.float32)

    noise = np.array(jax.lax.scan(split, key, None, length=1000)[1])
    want = j_sampler.sr3_ancestral_sample(j_resdiff_schedule(1000), eps_j, jnp.asarray(x_T), key, num_steps=None)
    got = t_sampler.sr3_ancestral_sample(resdiff_schedule(1000), eps_t, torch.from_numpy(x_T), num_steps=None,
                                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
