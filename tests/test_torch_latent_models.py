"""The port's latent SD1.5 modules against their Flax counterparts, on the CPU.

Flax parameters are drawn from numpy with a fixed seed and carried across by
``mrisr_torch.weights.load_flax_params``; inputs are numpy too, NHWC for JAX
and NCHW for the port.  Everything is float32, at the JAX bench's
``cpu_smoke`` sizes (block widths (8, 16, 16, 16), 2 heads, context 16; VAE
(8, 8, 16, 16); 64^2 condition).  Each module is held to atol 2e-4, rtol
1e-3 unless stated otherwise.

The UNet and ControlNet take a 128^2 condition (16^2 latents).  At 64^2 their
mid block sits at 1x1 with one channel a group: the variance is exactly 0,
the port's GroupNorm returns its bias, and the reference's returns its bias
plus its own rounding times rsqrt(eps) = 1000 (XLA computes (x - mean) * a
as x * a - mean * a), about 1e-4, which the blocks after it carry to 2e-3.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrisr_tpu.models import adapter as j_adapter
from mrisr_tpu.models import controlnet as j_cn
from mrisr_tpu.models import sd_layers as jl
from mrisr_tpu.models import sd_unet as j_unet
from mrisr_tpu.models import vae as j_vae
from mrisr_tpu.ops.resize import pixel_unshuffle as j_pixel_unshuffle
from mrisr_torch.models import adapter as t_adapter
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import sd_layers as tl
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.weights import load_flax_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TOL = dict(atol=2e-4, rtol=1e-3)
TINY = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
TINY_VAE = (8, 8, 16, 16)
TINY_ADAPTER = (8, 16, 16, 16)
COND, LATENT, CTX = 128, 16, (1, 7, 16)
VAE_IMG = 64


def flax_random_params(module, args, seed=0, method=None, **kw):
    """Params of ``module`` drawn from numpy: kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases ~ 0.1,
    embeddings ~ 0.1 (zero-initialised convs get random values too, so they carry signal)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, method=method, **kw), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("bias", "embedding", "position_embedding"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a.copy())


def nhwc(t):
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _x(*shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def assert_close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), err_msg=what, **tol)


@pytest.mark.parametrize("eps,temb", [(1e-5, True), (1e-6, False)], ids=["unet_eps1e-5", "vae_eps1e-6"])
def test_resnet_block2d(eps, temb):
    x = _x(2, 8, 8, 8, scale=2.0) + 0.5
    jmod = jl.ResnetBlock2D(16, groups=4, eps=eps, use_temb=temb)
    args = (jnp.asarray(x), jnp.asarray(_x(2, 32, seed=2))) if temb else (jnp.asarray(x),)
    params = flax_random_params(jmod, args)
    want = jmod.apply(params, *args)
    tmod = tl.ResnetBlock2D(8, 16, groups=4, eps=eps, temb_channels=32 if temb else None)
    load_flax_params(tmod, params)
    assert tmod.norm1.eps == eps and tmod.norm1.num_groups == 4
    with torch.no_grad():
        got = tmod(*(nchw(a) for a in args))
    assert_close(got, want)


@pytest.mark.parametrize("route", ["dense", "dense_cross", "flash"])
def test_attention_routes(route):
    """Dense up to 4096 keys; above, ``spatial_attention`` (the plain flash path on a CPU tensor; JAX's
    chunked path)."""
    n = 4608 if route == "flash" else 64
    x = _x(1, n, 8, scale=2.0)
    ctx = _x(1, 7, 16, seed=3) if route == "dense_cross" else None
    jmod = jl.Attention(heads=2, head_dim=4, out_dim=8)
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    params = flax_random_params(jmod, args)
    want = jmod.apply(params, *args)
    tmod = tl.Attention(8, 2, 4, 8, context_dim=None if ctx is None else 16)
    load_flax_params(tmod, params)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (x,) + (() if ctx is None else (ctx,))))
    assert (n > tl.DENSE_MAX_KEYS) == (route == "flash")
    assert_close(got, want)


def test_geglu_is_tanh_gelu():
    """The feed-forward gate is Flax's default tanh-approximate GELU, not torch's default erf."""
    x = _x(4, 16, scale=3.0)
    jmod = jl.GEGLU(8)
    params = flax_random_params(jmod, (jnp.asarray(x),))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod = tl.GEGLU(16, 8)
    load_flax_params(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
        h, gate = tmod.proj(torch.from_numpy(x)).chunk(2, dim=-1)
        erf = (h * F.gelu(gate)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(erf, want, **TOL)  # the erf form would miss the bar


@pytest.mark.parametrize("scale", [1.0, 3e-3], ids=["unit", "small_variance"])
def test_transformer2d(scale):
    """GroupNorm (eps 1e-6), the transformer block (LayerNorm eps 1e-6, tanh GELU), projections; at a small
    input variance the LayerNorm's eps shows."""
    x = _x(2, 8, 8, 8, scale=scale)
    ctx = _x(2, 7, 16, seed=3)
    jmod = jl.Transformer2D(heads=2, context_dim=16)
    params = flax_random_params(jmod, (jnp.asarray(x), jnp.asarray(ctx)))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tmod = tl.Transformer2D(8, 2, context_dim=16)
    load_flax_params(tmod, params)
    block = tmod.transformer_blocks_0
    assert {block.norm1.eps, block.norm2.eps, block.norm3.eps, tmod.norm.eps} == {1e-6}
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(ctx))
    assert_close(got, want, tol=dict(atol=2e-4 * scale, rtol=1e-3))


def _unet_inputs():
    x = _x(2, LATENT, LATENT, 4)
    t = np.array([999, 250], np.int32)
    ctx = np.broadcast_to(_x(*CTX, seed=4), (2,) + CTX[1:]).copy()
    cond = _x(2, COND, COND, 3, seed=5)
    return x, t, ctx, cond


@pytest.fixture(scope="module")
def controlnet_pair():
    """The JAX ControlNet's params and its residuals on ``_unet_inputs`` (one compile for the file), and the
    port's ControlNet with the same params."""
    x, t, ctx, cond = _unet_inputs()
    jcn = j_cn.ControlNet(**TINY)
    args = tuple(jnp.asarray(a) for a in (x, t, ctx, cond))
    params = flax_random_params(jcn, args, seed=7)
    tcn = t_cn.ControlNet(**TINY, device="cpu")
    load_flax_params(tcn, params)
    return jcn, params, tcn, jax.jit(jcn.apply)(params, *args)


def test_controlnet_and_embed_condition(controlnet_pair):
    jcn, params, tcn, (want_down, want_mid) = controlnet_pair
    x, t, ctx, cond = _unet_inputs()
    want_emb = j_cn.embed_condition(jcn, params, jnp.asarray(cond))
    with torch.no_grad():
        emb = t_cn.embed_condition(tcn, nchw(cond))
        down, mid = tcn(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), cond_embedding=emb)
        down_img, mid_img = tcn(nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx), cond_image=nchw(cond))
    assert_close(emb, want_emb, what="embed_condition")
    assert len(down) == len(want_down) == 12
    for i, (g, w) in enumerate(zip(down, want_down)):
        assert_close(g, w, what=f"down residual {i}")
        assert torch.equal(g, down_img[i])
    assert_close(mid, want_mid, what="mid residual")
    assert torch.equal(mid, mid_img)


@pytest.mark.parametrize("mode", ["controlnet_residuals", "adapter_features"])
def test_sd_unet(mode, controlnet_pair):
    x, t, ctx, cond = _unet_inputs()
    jx, jt, jctx, jcond = (jnp.asarray(a) for a in (x, t, ctx, cond))
    junet = j_unet.SDUNet(**TINY)
    params = flax_random_params(junet, (jx, jt, jctx), seed=8)
    tunet = t_unet.SDUNet(**TINY, device="cpu")
    load_flax_params(tunet, params)
    tt = torch.from_numpy(t).long()
    if mode == "controlnet_residuals":
        _, _, tcn, (jdown, jmid) = controlnet_pair
        want = jax.jit(lambda p, d, m: junet.apply(p, jx, jt, jctx, down_block_additional_residuals=d,
                                                    mid_block_additional_residual=m))(params, jdown, jmid)
        with torch.no_grad():
            down, mid = tcn(nchw(x), tt, torch.from_numpy(ctx), cond_image=nchw(cond))
            got = tunet(nchw(x), tt, torch.from_numpy(ctx), down_block_additional_residuals=down,
                        mid_block_additional_residual=mid)
    else:
        jad = j_adapter.T2IAdapter(channels=TINY_ADAPTER)
        ad_params = flax_random_params(jad, (jcond,), seed=9)
        feats = jax.jit(jad.apply)(ad_params, jcond)
        want = jax.jit(lambda p, f: junet.apply(p, jx, jt, jctx, adapter_features=f))(params, feats)
        tad = t_adapter.T2IAdapter(channels=TINY_ADAPTER, device="cpu")
        load_flax_params(tad, ad_params)
        with torch.no_grad():
            got = tunet(nchw(x), tt, torch.from_numpy(ctx), adapter_features=tad(nchw(cond)))
    assert_close(got, want)


@pytest.mark.parametrize("zero_out", [False, True])
def test_t2i_adapter(zero_out):
    cond = _x(2, COND, COND, 3, seed=5)
    jad = j_adapter.T2IAdapter(channels=TINY_ADAPTER, zero_out=zero_out)
    params = flax_random_params(jad, (jnp.asarray(cond),), seed=9)
    want = jad.apply(params, jnp.asarray(cond))
    tad = t_adapter.T2IAdapter(channels=TINY_ADAPTER, zero_out=zero_out, device="cpu")
    if zero_out:  # a fresh adapter with zero_out contributes nothing
        with torch.no_grad():
            assert all(float(f.abs().max()) == 0.0 for f in tad(nchw(cond)))
    load_flax_params(tad, params)
    with torch.no_grad():
        got = tad(nchw(cond))
    assert [tuple(g.shape[1:]) for g in got] == [(8, 16, 16), (16, 8, 8), (16, 4, 4), (16, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"feature {i}")


def test_pixel_unshuffle_channel_order():
    """``F.pixel_unshuffle`` orders channels as the reference's ``ops/resize.py::pixel_unshuffle``:
    (c, row offset, column offset)."""
    x = _x(2, 3, 16, 24, seed=11)
    want = np.asarray(j_pixel_unshuffle(jnp.asarray(x), 8))
    got = F.pixel_unshuffle(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def vae_pair():
    img = np.tanh(_x(2, VAE_IMG, VAE_IMG, 3, seed=12))
    jvae = j_vae.AutoencoderKL(block_out_channels=TINY_VAE)
    params = flax_random_params(jvae, (jnp.asarray(img),), seed=13)
    tvae = t_vae.AutoencoderKL(block_out_channels=TINY_VAE, device="cpu")
    load_flax_params(tvae, params)
    return img, jvae, params, tvae


def test_vae_encode_moments_and_sample(vae_pair):
    img, jvae, params, tvae = vae_pair
    key = jax.random.PRNGKey(3)
    mean, logvar = jvae.apply(params, jnp.asarray(img), method=jvae.encode_moments)
    sample = jvae.apply(params, jnp.asarray(img), key, method=jvae.encode)
    noise = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))
    with torch.no_grad():
        t_mean, t_logvar = tvae.encode_moments(nchw(img))
        t_sample = tvae.encode(nchw(img), nchw(noise))
        t_mode = tvae.encode(nchw(img))
    assert_close(t_mean, mean, what="mean")
    assert_close(t_logvar, logvar, what="logvar")
    assert_close(t_sample, sample, what="posterior sample")
    assert torch.equal(t_mode, t_mean)
    assert float(t_logvar.min()) >= -30.0 and float(t_logvar.max()) <= 20.0


def test_vae_decode(vae_pair):
    _, jvae, params, tvae = vae_pair
    z = _x(2, VAE_IMG // 8, VAE_IMG // 8, 4, seed=14)
    want = jvae.apply(params, jnp.asarray(z), method=jvae.decode)
    with torch.no_grad():
        got = tvae.decode(nchw(z))
    assert tuple(got.shape) == (2, 3, VAE_IMG, VAE_IMG)
    assert_close(got, want)
    assert t_vae.SD15_SCALING_FACTOR == j_vae.SD15_SCALING_FACTOR == tvae.scaling_factor


def test_gn_groups_and_b3_heads():
    """``gn_groups`` keeps its gcd fallback; every GroupNorm followed by SiLU in the three SD modules is
    a ``ResnetBlock2D`` head or a ``conv_norm_out`` (the fused kernel's sites), with the block's eps."""
    assert [tl.gn_groups(c) for c in (320, 8, 12, 2560)] == [jl.gn_groups(c) for c in (320, 8, 12, 2560)]
    unet, vae = t_unet.SDUNet(**TINY, device="cpu"), t_vae.AutoencoderKL(TINY_VAE, device="cpu")
    heads = {id(m.norm1) for m in unet.modules() if isinstance(m, tl.ResnetBlock2D)}
    assert len(heads) == 22 and unet.conv_norm_out.eps == 1e-5
    assert {m.norm1.eps for m in vae.modules() if isinstance(m, tl.ResnetBlock2D)} == {1e-6}
    assert vae.encoder.conv_norm_out.eps == vae.decoder.conv_norm_out.eps == 1e-6
