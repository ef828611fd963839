"""The port's ResDiff layers and UNet against their Flax counterparts, on the CPU.

Flax parameters are drawn from numpy with a fixed seed and carried across by
``mrisr_torch.weights.load_flax_params``; inputs are numpy too.  Everything is
float32.  Layer tolerances are float32 rounding of differently ordered sums;
the UNet forward is held to the North-star bar (atol 2e-4, rtol 1e-3).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.models import layers as jl
from mrisr_tpu.models.resdiff_unet import FDInfoSpliter as JFD
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_tpu.models.simple_cnn import SimpleCNN as JCNN
from mrisr_tpu.ops.resize import interpolate_like_torch
from mrisr_torch.models import layers as tl
from mrisr_torch.models.resdiff_unet import FDInfoSpliter as TFD
from mrisr_torch.models.resdiff_unet import ResDiffUNet as TUNet
from mrisr_torch.models.simple_cnn import SimpleCNN as TCNN
from mrisr_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent


def flax_random_params(module, args, seed=0, **kw):
    """Params of ``module`` drawn from numpy: kernels ~ N(0, 1/fan_in), GN scale ~ 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_torch(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a)


def to_numpy(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _run_pair(jmod, tmod, args, seed=0, atol=2e-5, rtol=1e-4, method=None, init_args=None, **kw):
    jargs = tuple(jnp.asarray(a) for a in args)
    init = jargs if init_args is None else tuple(jnp.asarray(a) for a in init_args)
    params = flax_random_params(jmod, init, seed, **kw)
    want = jax.jit(lambda p, *a: jmod.apply(p, *a, method=method, **kw))(params, *jargs)
    load_flax_params(tmod, params)
    fn = tmod if method is None else getattr(tmod, method)
    with torch.no_grad():
        got = fn(*(to_torch(a) for a in args), **kw)
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=atol, rtol=rtol)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


EMB = _x(2, 32, seed=2)
LAYER_CASES = {
    "noise_level_mlp": (lambda: jl.NoiseLevelMLP(32), lambda: tl.NoiseLevelMLP(32),
                        (np.array([0.1, 0.73, 0.99], np.float32),), {}),
    "se_block": (lambda: jl.SEBlock(2), lambda: tl.SEBlock(4, 2), (_x(2, 8, 8, 4),), {}),
    "conv_block": (lambda: jl.ConvBlock(16, 4), lambda: tl.ConvBlock(8, 16, 4), (_x(2, 8, 8, 8),), {}),
    "resnet_block": (lambda: jl.ResnetBlock(16, 4), lambda: tl.ResnetBlock(8, 16, 4, 32),
                     (_x(2, 8, 8, 8), EMB), {}),
    "self_attention": (lambda: jl.SelfAttention2D(4), lambda: tl.SelfAttention2D(16, 4),
                       (_x(2, 8, 8, 16),), {}),
    "resnet_block_with_attn": (lambda: jl.ResnetBlockWithAttn(16, 4, with_attn=True),
                               lambda: tl.ResnetBlockWithAttn(8, 16, 4, 32, True),
                               (_x(2, 8, 8, 8), EMB), {}),
    "downsample": (lambda: jl.Downsample(8), lambda: tl.Downsample(8), (_x(2, 8, 8, 8),), {}),
    "upsample": (lambda: jl.Upsample(8), lambda: tl.Upsample(8), (_x(2, 4, 4, 8),), {}),
    "hf_cross_attention": (lambda: jl.HFGuidedCrossAttention(4), lambda: tl.HFGuidedCrossAttention(16, 4),
                           (_x(2, 8, 8, 16), _x(2, 8, 8, 1, seed=3)), {}),
    "hf_cross_attention_kv_pool": (lambda: jl.HFGuidedCrossAttention(4),
                                   lambda: tl.HFGuidedCrossAttention(16, 4),
                                   (_x(2, 8, 8, 16), _x(2, 8, 8, 1, seed=3)), {"kv_pool": 2}),
    "fd_spliter": (lambda: JFD(32, 16), lambda: TFD(32, 16), (_x(2, 16, 16, 2), EMB), {}),
    "simple_cnn": (lambda: JCNN(), lambda: TCNN(device="cpu"), (_x(2, 8, 8, 1),), {}),
    "simple_cnn_x2": (lambda: JCNN(2), lambda: TCNN(2, device="cpu"), (_x(2, 8, 8, 1),), {}),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_flax(name):
    jmake, tmake, args, kw = LAYER_CASES[name]
    _run_pair(jmake(), tmake(), args, **kw)


def test_fd_static_features_match_at_batch_3():
    cnn = _x(3, 16, 16, 1, seed=4)
    init_args = (_x(3, 16, 16, 2, seed=5), _x(3, 32, seed=6))
    _run_pair(JFD(32, 16), TFD(32, 16), (cnn,), method="static_features", init_args=init_args)


def test_nearest_up2_and_bicubic_match_reference():
    x = _x(2, 5, 6, 3)
    np.testing.assert_array_equal(
        to_numpy(tl.nearest_up2(to_torch(x))), np.asarray(jl.nearest_up2(jnp.asarray(x)))
    )
    xc = x.transpose(0, 3, 1, 2)
    want = np.asarray(interpolate_like_torch(jnp.asarray(xc), (10, 12)))
    got = torch.nn.functional.interpolate(torch.from_numpy(xc), scale_factor=2, mode="bicubic",
                                          align_corners=False)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# Tiny UNet: 32^2, inner 8, GroupNorm(4); every CA site pools when kv_pool > 1
# ---------------------------------------------------------------------------

TINY = dict(image_size=32, inner_channel=8, norm_groups=4)
MIN_TOKENS = 64


def _unet_pair(kv_pool, s2d):
    x = _x(2, 32, 32, 2, seed=5)
    gamma = np.array([0.7, 0.2], np.float32)
    ju = JUNet(**TINY, dropout=0.0, s2d_level0=s2d, ca_kv_pool=kv_pool,
               ca_kv_pool_min_tokens=MIN_TOKENS)
    tu = TUNet(**TINY, ca_kv_pool=kv_pool, ca_kv_pool_min_tokens=MIN_TOKENS, device="cpu")
    return ju, tu, x, gamma


@pytest.mark.parametrize("kv_pool,s2d", [(0, False), (2, False), (0, True), (2, True)])
def test_tiny_unet_forward_matches_jax(kv_pool, s2d):
    """s2d=False is the reference's plain path; s2d=True its default TPU form."""
    ju, tu, x, gamma = _unet_pair(kv_pool, s2d)
    _run_pair(ju, tu, (x, gamma), seed=6, atol=2e-4, rtol=1e-3)


def test_compute_static_matches_at_batch_3():
    ju, tu, _, _ = _unet_pair(0, False)
    cnn = _x(3, 32, 32, 1, seed=7)
    x = np.concatenate([cnn, _x(3, 32, 32, 1, seed=8)], axis=-1)
    gamma = np.full((3,), 0.5, np.float32)
    params = flax_random_params(ju, (jnp.asarray(x), jnp.asarray(gamma)), seed=9)
    (jlf, jhf), jq = jax.jit(lambda p, c: ju.apply(p, c, method="compute_static"))(params, jnp.asarray(cnn))
    load_flax_params(tu, params)
    with torch.no_grad():
        (tlf, thf), tq = tu.compute_static(to_torch(cnn))
        assert len(tq) == len(jq) == 3
        for w, g in zip((jlf, jhf, *jq), (tlf, thf, *tq)):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=2e-5, rtol=1e-4)
        # Passing the static features gives the same eps as computing them inline.
        static = tu.compute_static(to_torch(cnn))
        torch.testing.assert_close(tu(to_torch(x), torch.from_numpy(gamma), static=static),
                                   tu(to_torch(x), torch.from_numpy(gamma)))


def test_checkpoint_keys_cover_the_port():
    """Every leaf of ckpt_256_r3.msgpack's EMA tree fills one port parameter."""
    from flax import serialization

    blob = serialization.msgpack_restore((REPO / "ckpt_256_r3.msgpack").read_bytes())
    tree = blob["ema"]
    leaves = jax.tree_util.tree_leaves(tree)
    # The checkpoint's training config: norm_groups=8 (tools/twin_trained_chain.py).
    tu = TUNet(image_size=256, norm_groups=8, device="cpu")
    params = list(tu.parameters())
    assert len(leaves) == len(params)
    assert sum(np.asarray(a).size for a in leaves) == sum(p.numel() for p in params)
    load_flax_params(tu, tree)
    p = tree["params"]
    np.testing.assert_array_equal(
        tu.conv_in.weight.detach().numpy(), np.asarray(p["conv_in"]["kernel"]).transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        tu.NoiseLevelMLP_0.Dense_1.weight.detach().numpy(), np.asarray(p["NoiseLevelMLP_0"]["Dense_1"]["kernel"]).T
    )
    gn = p["ResnetBlockWithAttn_4"]["SelfAttention2D_0"]["GroupNorm_0"]
    np.testing.assert_array_equal(
        tu.ResnetBlockWithAttn_4.SelfAttention2D_0.GroupNorm_0.weight.detach().numpy(), np.asarray(gn["scale"])
    )


def test_load_flax_params_rejects_missing_and_extra_leaves():
    tu = tl.ConvBlock(8, 16, 4)
    good = {"GroupNorm_0": {"scale": np.ones(8), "bias": np.zeros(8)},
            "Conv_0": {"kernel": np.zeros((3, 3, 8, 16)), "bias": np.zeros(16)}}
    load_flax_params(tu, good)
    with pytest.raises(KeyError):
        load_flax_params(tu, {**good, "Conv_1": {"kernel": np.zeros((1, 1, 8, 8))}})
    with pytest.raises(KeyError):
        load_flax_params(tu, {"GroupNorm_0": good["GroupNorm_0"]})
    with pytest.raises(ValueError):
        load_flax_params(tu, {**good, "Conv_0": {"kernel": np.zeros((3, 3, 8, 8)), "bias": np.zeros(16)}})
