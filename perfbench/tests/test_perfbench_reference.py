"""The frozen plain reference against the port's plain CPU path, at tiny widths on the same weights and inputs."""
from __future__ import annotations

import pytest
import torch

from perfbench import run, weights
from perfbench.reference import resdiff as ref


def port_and_reference(config, pool, seed=5):
    from mrisr_torch.diffusion.schedules import make_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    c = config
    cnn = SimpleCNN(hidden=c["cnn_hidden"], device="cpu")
    unet = ResDiffUNet(image_size=c["image_size"], inner_channel=c["inner_channel"],
                       channel_mults=tuple(c["channel_mults"]), norm_groups=c["norm_groups"], ca_kv_pool=pool,
                       ca_kv_pool_min_tokens=c["ca_kv_pool_min_tokens"], device="cpu")
    r_cnn = ref.SimpleCNN(c["cnn_hidden"])
    r_unet = ref.ResDiffUNet(c["image_size"], c["inner_channel"], c["channel_mults"], c["res_blocks"], c["attn_res"],
                             c["norm_groups"], pool, c["ca_kv_pool_min_tokens"])
    for port, plain, stream in ((cnn, r_cnn, 1), (unet, r_unet, 2)):
        w = weights.make(weights.ranges(plain), seed, stream, torch.float32, "cpu")
        weights.load(port, w)
        weights.load(plain, w)
    sched = make_schedule("linear", c["timesteps"], c["beta_start"], c["beta_end"])
    return ResDiffPipeline(cnn, unet, sched, device="cpu"), r_cnn, r_unet


@pytest.mark.parametrize("pool", [0, 8])
def test_resdiff_chain_matches_the_port(pool):
    """A 2-step chain in both profiles (K/V pooled 8x8 at the 32^2 and 16^2 sites in the fast one): the float32
    reference and the port's plain path agree to float32 rounding."""
    config = {**run.find_cell("resdiff-exact-serve").config, "image_size": 64, "inner_channel": 8, "norm_groups": 4,
              "ca_kv_pool_min_tokens": 256}
    pipe, r_cnn, r_unet = port_and_reference(config, pool)
    g = torch.Generator().manual_seed(3)
    lr = torch.rand((2, 64, 64, 1), generator=g) * 2 - 1
    x_T = torch.randn((2, 64, 64, 1), generator=g)
    with torch.no_grad():
        out = pipe.super_resolve(lr, x_T=x_T, num_steps=2)
        sr, cnn_sr = ref.chain(r_cnn, r_unet, lr.reshape(2, 1, 64, 64), x_T.reshape(2, 1, 64, 64), 2)
    sr = sr.reshape(2, 64, 64, 1)
    assert float((sr - cnn_sr.reshape(2, 64, 64, 1)).abs().max()) > 0.1  # the chain adds something
    torch.testing.assert_close(out, sr, rtol=1e-4, atol=1e-4)


def test_reference_notes_the_work_of_a_step():
    """The recorder notes the UNet's attention sites and GroupNorm+SiLU heads once: three cross-attention sites,
    the mid self-attention, and 29 heads (two a ResnetBlock, the final ConvBlock)."""
    cell = run.find_cell("resdiff-exact-serve")
    system = cell.system_cls(cell.config, cell.traffic, 1, "cpu")
    work = system.work()
    assert [(a["b"], a["n"], a["m"], a["d"]) for a in work["attention"]] == [(8, 16384, 16384, 32), (8, 4096, 4096, 64)]
    assert all(a["count"] == 50 for a in work["attention"])
    assert len(work["gn_silu"]) == 29
    per_step_slice = sum(work["flops"][0]["ops"].values()) / 50 / 8
    assert per_step_slice == pytest.approx(8.685e10, rel=2e-3)


def test_fast_profile_pools_the_long_sites():
    cell = run.find_cell("resdiff-fast-serve")
    work = cell.system_cls(cell.config, cell.traffic, 1, "cpu").work()
    assert [(a["n"], a["m"]) for a in work["attention"]] == [(16384, 256), (4096, 64)]
    assert sum(work["flops"][0]["ops"].values()) / 50 / 8 == pytest.approx(4.867e10, rel=2e-3)
