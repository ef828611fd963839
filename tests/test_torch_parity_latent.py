"""The fidelity harness's latent leg (``run_phantom_latent``, ``parity-latent``) against the JAX package's, on the CPU.

JAX's run with every training leg at 0 steps is a module fixture: its rows
(base UNet, ControlNet, LoRA, the rank sweep, the longer chains) are those of
the untrained modules, so the port, given JAX's initial weights, prompt and
chain noise, must give the same PSNR per image (within 0.01 dB).  The
command line with every leg on writes the same key tree.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.eval import parity as j_parity
from mrisr_tpu.models.controlnet import ControlNet as JCN
from mrisr_tpu.models.sd_unet import SDUNet as JSD
from mrisr_tpu.models.vae import AutoencoderKL as JVAE
from mrisr_torch import cli as t_cli
from mrisr_torch.eval import parity as t_parity
from mrisr_torch.models.controlnet import ControlNet as TCN
from mrisr_torch.models.sd_unet import SDUNet as TSD
from mrisr_torch.models.vae import AutoencoderKL as TVAE
from mrisr_torch.pipelines.latent import ChainNoise
from test_torch_latent_pipeline import _jax_chain_noise, nchw
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from test_torch_parity import PSNR_BAR_DB, _keys, _named

LAT = dict(res=32, n_train=8, n_test=4, batch=2, vae_steps=0, base_steps=0, cn_steps=0, lora_steps=0,
           num_inference_steps=2, sample_seeds=(2, 3), vae_width=8, unet_width=8, lora_ranks=(2,),
           extra_sample_steps=(3,))
UNTRAINED_ROWS = ("base_unet", "controlnet", "lora", "lora_r2")


def _jax_latent_noise(seed, steps, shape):
    """The draws of JAX's ``LatentSRPipeline.super_resolve_with`` under ``PRNGKey(seed)`` (NCHW ``shape``)."""
    b, c, h, w = shape
    key, k_enc = jax.random.split(jax.random.PRNGKey(seed))
    vae = np.asarray(jax.random.normal(k_enc, (b, h, w, c), jnp.float32))
    start, step = _jax_chain_noise(key, (b, h, w, c), steps)
    return ChainNoise(nchw(vae), nchw(start), torch.from_numpy(np.ascontiguousarray(step.transpose(0, 1, 4, 2, 3))))


@pytest.fixture(scope="module")
def latent_runs():
    """JAX's run (the VAE ``PRNGKey(0)``, the towers ``split(PRNGKey(1))``, the prompt ``PRNGKey(42)``) and the
    port's from those weights and that prompt."""
    res, w, uw = LAT["res"], LAT["vae_width"], LAT["unet_width"]
    want = j_parity.run_phantom_latent(**LAT)
    vae_cfg = dict(block_out_channels=(w, 2 * w, 4 * w), latent_channels=4)
    tower = dict(block_out_channels=(uw, 2 * uw, 2 * uw, 2 * uw), heads=2, context_dim=16)
    f = res // 4
    lat0, ctx0 = jnp.zeros((1, f, f, 4)), jnp.zeros((1, 7, 16))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    trees = {
        "vae": (JVAE(**vae_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3))),
                TVAE(**vae_cfg, device="cpu")),
        "unet": (JSD(**tower).init(k1, lat0, jnp.array([1]), ctx0), TSD(**tower, device="cpu")),
        "controlnet": (JCN(**tower, cond_block_channels=(8, 16, 32)).init(
            k2, lat0, jnp.array([1]), ctx0, jnp.zeros((1, res, res, 3))),
            TCN(**tower, cond_block_channels=(8, 16, 32), device="cpu")),
    }
    params = {name: _named(module, tree) for name, (tree, module) in trees.items()}
    params["prompt"] = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(42), (1, 7, 16), jnp.float32)))
    got = t_parity.run_phantom_latent(**LAT, device="cpu", params=params, noise=_jax_latent_noise)
    return want, got


def test_phantom_latent_untrained_rows_match_jax_per_image(latent_runs):
    """The report's key tree is JAX's; every row (base, ControlNet, LoRA, the rank sweep, and the 3-step
    chains) per image within 0.01 dB, its bicubic verdict with it; the empirical scaling factor, the VAE
    ceiling and the bicubic baseline."""
    want, got = latent_runs
    assert _keys(got) == _keys(want)
    np.testing.assert_allclose(got["config"]["vae"]["scaling_factor"], want["config"]["vae"]["scaling_factor"],
                               rtol=1e-4)
    assert {k: v for k, v in got["config"].items() if k != "vae"} == {
        k: v for k, v in want["config"].items() if k != "vae"}
    for row in ("vae_recon_ceiling", "bicubic_baseline"):
        assert abs(got[row]["psnr"] - want[row]["psnr"]) < PSNR_BAR_DB, row
    rows = [(name, got[name], want[name]) for name in UNTRAINED_ROWS]
    rows += [(f"{name} @3", got[name]["steps_3"], want[name]["steps_3"]) for name in ("controlnet", "lora")]
    for name, g, w in rows:
        gp, wp = np.array(g["per_image"]["psnr"]), np.array(w["per_image"]["psnr"])
        assert gp.shape == (8,) and np.abs(gp - wp).max() < PSNR_BAR_DB, name
        assert g["beats_bicubic"] == w["beats_bicubic"], name
    assert abs(got["controlnet_minus_base_psnr"]["mean"] - want["controlnet_minus_base_psnr"]["mean"]) < PSNR_BAR_DB


def test_parity_latent_cli_writes_the_references_key_tree(tmp_path, latent_runs):
    """``parity-latent --cpu`` with every leg on (adapter, ControlNet+LoRA, the rank sweep, a longer chain),
    cached latents and chunked training: JSON with JAX's key tree.  The adapter and ControlNet+LoRA rows,
    which the fixture's JAX run leaves out, have the tree of JAX's ControlNet row (every row of the reference
    is built by one function); their step counts sit in ``config.steps`` in both."""
    want, _ = latent_runs
    want = json.loads(json.dumps(want))
    for name in ("adapter", "cn_lora"):
        want[name] = want["controlnet"]
    out = tmp_path / "pl.json"
    t_cli.run(["parity-latent", "--cpu", "--out", str(out), "--resolution", "32", "--n-train", "8", "--n-test", "4",
               "--batch", "2", "--vae-steps", "2", "--base-steps", "2", "--cn-steps", "1", "--lora-steps", "1",
               "--inference-steps", "2", "--vae-width", "8", "--unet-width", "8", "--adapter-steps", "1",
               "--cn-lora-steps", "1", "--lora-ranks", "2", "--extra-sample-steps", "3", "--cache-latents",
               "--chunk-steps", "1", "--prediction-type", "sample"])
    got = json.loads(out.read_text())
    assert _keys(got) == _keys(want)
    assert got["config"]["steps"] == {"vae": 2, "base": 2, "cn": 1, "lora": 1, "adapter": 1, "cn_lora": 1}
