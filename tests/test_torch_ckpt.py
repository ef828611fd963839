"""The port on the trained checkpoint (``ckpt_256_r3.msgpack``) against the JAX package, fp32, on the CPU.

The checkpoint's EMA UNet at full width (256², inner 32, 8 norm groups) goes
into both packages: JAX through flax, the port through its own msgpack
reader.  The inputs are those of ``tools/torch_ckpt_chain.py``: a held-out
phantom's LR image as the condition, a numpy draw as the starting noise.
Here one eps forward and the first three steps of the trailing 50-step DDIM
table in each profile; the whole 2-image, 50-step comparison (the tool's) is
the slow test at the end, and its recorded result is checked against the
bar of 0.01 dB per image.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mrisr_tpu.diffusion import ddim as j_ddim
from mrisr_tpu.diffusion.schedules import resdiff_schedule as j_resdiff_schedule
from mrisr_tpu.diffusion.schedules import spaced_timesteps
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_torch.diffusion import ddim as t_ddim
from mrisr_torch.diffusion.schedules import resdiff_schedule
from test_torch_resdiff import to_numpy, to_torch

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_ckpt_chain", REPO / "tools" / "torch_ckpt_chain.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

# The North-star forward bar, for one eps and for x after three chained steps
# (each step scales the eps difference by about sqrt(1 - ac_prev) after the
# clip; the tool's run records 1.4e-6 after three steps).
FORWARD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def ckpt():
    params = serialization.msgpack_restore(tool.CKPT.read_bytes())["ema"]
    hr, cond, x_T = tool.inputs(1)
    return params, cond, x_T


@pytest.fixture(scope="module")
def jax_eps_fns(ckpt):
    params, cond, _ = ckpt
    fns = {}

    def get(kv_pool):
        if kv_pool not in fns:
            unet = JUNet(**tool.UNET, ca_kv_pool=kv_pool)
            static = unet.apply(params, jnp.asarray(cond), method="compute_static")
            fns[kv_pool] = jax.jit(lambda x, g: unet.apply(params, x, g, static=static))
        return fns[kv_pool]

    return get


@pytest.fixture(scope="module")
def port_unets():
    unets = {}

    def get(kv_pool):
        if kv_pool not in unets:
            unets[kv_pool] = tool.port_pipeline(kv_pool).unet
        return unets[kv_pool]

    return get


def test_checkpoint_eps_forward_matches_jax(ckpt, jax_eps_fns, port_unets):
    _, cond, x_T = ckpt
    gamma = np.asarray(j_resdiff_schedule(1000).sqrt_alphas_cumprod)[[999]].astype(np.float32)
    x = np.concatenate([cond, x_T], axis=-1)
    want = np.asarray(jax_eps_fns(0)(jnp.asarray(x), jnp.asarray(gamma)))
    with torch.no_grad():
        got = to_numpy(port_unets(0)(to_torch(x), torch.from_numpy(gamma)))
    np.testing.assert_allclose(got, want, **FORWARD_TOL)


@pytest.mark.parametrize("profile", ["exact", "fast"])
def test_three_ddim_steps_match_jax(ckpt, jax_eps_fns, port_unets, profile):
    _, cond, x_T = ckpt
    kv_pool = tool.PROFILES[profile]
    j_sched, t_sched = j_resdiff_schedule(1000), resdiff_schedule(1000)
    unet = port_unets(kv_pool)
    cond_t = to_torch(cond)
    with torch.no_grad():
        static = unet.compute_static(cond_t)
    ts = [int(t) for t in spaced_timesteps(1000, 50, "trailing")]
    xj, xt = jnp.asarray(x_T), to_torch(x_T)
    for t, tp in zip(ts[:3], ts[1:4]):
        tbj, tpj = jnp.full((1,), t, jnp.int32), jnp.full((1,), tp, jnp.int32)
        eps = jax_eps_fns(kv_pool)(jnp.concatenate([jnp.asarray(cond), xj], axis=-1), j_sched.sqrt_alphas_cumprod[tbj])
        xj = j_ddim.ddim_step(j_sched, xj, tbj, tpj, eps, None, 0.0, True)
        tbt, tpt = torch.full((1,), t), torch.full((1,), tp)
        with torch.no_grad():
            eps = unet(torch.cat([cond_t, xt], dim=1), t_sched.sqrt_alphas_cumprod[tbt], static=static)
        xt = t_ddim.ddim_step(t_sched, xt, tbt, tpt, eps)
    np.testing.assert_allclose(to_numpy(xt), np.asarray(xj), **FORWARD_TOL)


def test_recorded_fifty_step_comparison_meets_the_bar():
    """``PARITY_TORCH_CKPT.json`` (the tool's run): per-image |dPSNR| <= 0.01 dB in both profiles, and the
    JAX PSNRs it records are those of the final images in ``PARITY_TORCH_CKPT_ref.npz``."""
    report = json.loads((REPO / "PARITY_TORCH_CKPT.json").read_text())
    ref = np.load(REPO / "PARITY_TORCH_CKPT_ref.npz")
    assert report["steps"] == 50 and report["images"] == 2 and report["unet"] == tool.UNET
    assert ref["hr"].shape == ref["cond"].shape == ref["x_T"].shape == ref["eps"].shape == (2, 256, 256, 1)
    for name in tool.PROFILES:
        prof = report["profiles"][name]
        assert max(prof["abs_delta_db"]) <= tool.BAR_DB and prof["within_bar"]
        assert len(prof["per_step_max_abs_delta"]) == 50
        np.testing.assert_allclose(tool.psnr_per_image(ref[f"final_{name}"], ref["hr"]), prof["psnr_jax"], atol=1e-6)
        np.testing.assert_allclose(tool.psnr_per_image(ref[f"final_{name}_bf16"], ref["hr"]), prof["psnr_jax_bf16"],
                                   atol=1e-6)


@pytest.mark.slow
def test_fifty_step_chains_hold_to_jax():
    """The tool's whole comparison, run anew: 2 images, 50 steps, both profiles (about fifteen minutes)."""
    _, report = tool.run(50, 2, log=lambda *_: None)
    for name in tool.PROFILES:
        assert max(report["profiles"][name]["abs_delta_db"]) <= tool.BAR_DB, report["profiles"][name]
