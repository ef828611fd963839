"""The volume driver over the latent family on the CPU: a ``LatentSRPipeline`` served serially (one batch a
call) and grouped, and a pipeline whose output has 3 channels restacked from channel 0, against the JAX
package's driver."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.pipelines import volume as j_volume
from mrisr_torch.data import nifti as t_nifti
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.pipelines import volume as t_volume
from mrisr_torch.pipelines.latent import LatentSRPipeline
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

NET = dict(block_out_channels=(8, 16), layers_per_block=1, heads=2, context_dim=16)
VAE = (8, 8, 16, 16)
KW = dict(resolution=64, batch_size=2, num_steps=2, seed=7)


@pytest.fixture(scope="module")
def latent_pipeline():
    torch.manual_seed(0)
    unet, cn = t_unet.SDUNet(**NET, device="cpu"), t_cn.ControlNet(**NET, device="cpu")
    vae = t_vae.AutoencoderKL(VAE, device="cpu")
    prompt = 0.1 * torch.randn(1, 7, 16, generator=torch.Generator().manual_seed(1))
    return LatentSRPipeline(unet, cn, vae, t_sched.sd15_schedule(), prompt, device="cpu")


def test_latent_volume_serial_equals_grouped_and_each_batch(tmp_path, latent_pipeline):
    """A 40x36x5 volume at 64^2, bs 2, 2 steps: served one batch a call (G = 1) and two a call (G = 2), the
    volumes are bitwise equal; each batch equals the pipeline's own ``super_resolve`` of that batch with its
    generator (channel 0, cropped back and mapped to [0, 1])."""
    vol = np.random.default_rng(3).uniform(0, 1000, (40, 36, 5)).astype(np.float32)
    src = tmp_path / "in.nii"
    t_nifti.write_nifti(src, vol, np.eye(4))
    serial = t_volume.super_resolve_volume(latent_pipeline, src, **KW)
    grouped = t_volume.super_resolve_volume(latent_pipeline, src, chain_group=2, **KW)
    assert serial.data.shape == vol.shape and np.isfinite(serial.data).all()
    np.testing.assert_array_equal(grouped.data, serial.data)
    slices, shapes = t_volume.volume_to_model_slices(vol, 2, KW["resolution"])
    for s in range(0, vol.shape[2], KW["batch_size"]):
        batch = slices[s : s + KW["batch_size"]]
        if len(batch) < KW["batch_size"]:  # the driver repeats the last slice to fill a batch
            batch = np.concatenate([batch, np.repeat(batch[-1:], KW["batch_size"] - len(batch), 0)])
        gen = t_volume.batch_generator(torch.device("cpu"), KW["seed"], s)
        sr = latent_pipeline.super_resolve(torch.from_numpy(batch), gen, KW["num_steps"]).numpy()
        want = t_volume.restack_slices(sr[: min(KW["batch_size"], vol.shape[2] - s)], shapes[s : s + 2], 2)
        np.testing.assert_array_equal(serial.data[:, :, s : s + KW["batch_size"]], want)


class _JaxStub3:
    """A deterministic stand-in for a JAX pipeline with 3 output channels (as a latent pipeline's)."""

    def super_resolve(self, lr, key, num_steps=50):
        return jnp.concatenate([lr[:, :, ::-1, :] * 0.5, lr * 0.25, -lr], axis=-1)

    def super_resolve_group(self, stack, keys, num_steps=50):
        return jnp.concatenate([stack[:, :, :, ::-1, :] * 0.5, stack * 0.25, -stack], axis=-1)


class _PortStub3:
    device = torch.device("cpu")

    def super_resolve(self, lr, generator=None, x_T=None, num_steps=50):
        return torch.cat([torch.flip(lr, dims=[2]) * 0.5, lr * 0.25, -lr], dim=-1)

    def super_resolve_group(self, stack, generator=None, num_steps=50):
        return torch.cat([torch.flip(stack, dims=[3]) * 0.5, stack * 0.25, -stack], dim=-1)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("shape", [(20, 18, 5), (30, 12, 3)])
def test_three_channel_output_restacks_channel_0_as_jax(tmp_path, shape, group):
    vol = np.random.default_rng(8).uniform(0, 1000, shape).astype(np.float32)
    src = tmp_path / "in.nii"
    t_nifti.write_nifti(src, vol, np.diag([1.0, 1.0, 2.0, 1.0]))
    kw = dict(axis=2, resolution=24, batch_size=2, num_steps=3, seed=5, chain_group=group)
    got = t_volume.super_resolve_volume(_PortStub3(), src, **kw)
    want = j_volume.super_resolve_volume(_JaxStub3(), src, **kw)
    np.testing.assert_array_equal(got.data, want.data)
