"""The int8 serving profile (``mrisr_torch/ops/quant.py``, ``ResDiffUNet(conv_int8=True)``) against the JAX
package's, on the CPU.

``int8_conv`` is held to JAX's bit for bit on the same input (both round half to even, both accumulate the
integer products exactly and dequantize in float32 by the same two operations).  The quantizers are held to
JAX's bitwise and to half a quantization step.  A tiny ``ResDiffUNet`` (the JAX test's: 32^2, inner 8, mults
(1, 2), 4 groups) has the exact profile's parameter tree; on one set of numpy-drawn weights its output is
within relative L2 1e-3 of JAX's int8 UNet (a value near a rounding boundary may round the other way in one
package) and moves off the exact output by 0 < rel < 0.25, the JAX test's bound.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.models import resdiff_unet as j_unet
from mrisr_tpu.ops import quant as j_quant
from mrisr_torch.models import resdiff_unet as t_unet
from mrisr_torch.models.layers import PlainConvInt8
from mrisr_torch.ops import quant as t_quant
from mrisr_torch.weights import flax_named, load_flax_params
from test_torch_latent_pipeline import flax_random_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

UNET = dict(image_size=32, inner_channel=8, channel_mults=(1, 2), norm_groups=4, attn_res=(8,))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("case", [
    # (B, H, W, I, O, stride, bias, dtype)
    (2, 16, 16, 8, 16, 1, True, "float32"),
    (1, 9, 7, 5, 3, 1, False, "float32"),
    (2, 15, 13, 4, 8, 2, True, "float32"),
    (2, 12, 12, 16, 8, 1, True, "bfloat16"),
])
def test_int8_conv_bitwise_equals_jax(case):
    """``int8_conv`` (NCHW / OIHW) equals JAX's (NHWC / HWIO) bit for bit: odd sizes, SAME padding at stride 2,
    no bias, and a bf16 input (the result in the input's dtype)."""
    b, h, w, i, o, s, with_bias, dtype = case
    rng = np.random.default_rng(sum(case[:6]))
    x = rng.standard_normal((b, h, w, i)).astype(np.float32)
    k = (rng.standard_normal((3, 3, i, o)) / 3).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32) if with_bias else None
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_quant.int8_conv(jx, jnp.asarray(k), None if bias is None else jnp.asarray(bias),
                                        window_strides=(s, s)).astype(jnp.float32))
    tx = _nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = t_quant.int8_conv(tx, _oihw(k), None if bias is None else torch.from_numpy(bias), (s, s))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


def test_quantizers_equal_jax_and_round_trip():
    """Per-tensor and per-output-channel quantization: the int8 values and scales equal JAX's, and the
    dequantized values lie within half a step of the input."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
    jq, js = j_quant.quantize_per_tensor(jnp.asarray(x))
    q, s = t_quant.quantize_per_tensor(_nchw(x))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(jq))
    assert float((q.float() * s - _nchw(x)).abs().max()) <= float(s) / 2 + 1e-6
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    jqw, jsw = j_quant.quantize_per_out_channel(jnp.asarray(w))
    qw, sw = t_quant.quantize_per_out_channel(_oihw(w))
    assert qw.shape == (16, 8, 3, 3) and sw.shape == (16,)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw).transpose(3, 2, 0, 1))
    assert float((qw.float() * sw[:, None, None, None] - _oihw(w)).abs().max()) <= float(sw.max()) / 2 + 1e-6


def test_unet_int8_profile_matches_jax():
    """``ResDiffUNet(conv_int8=True)``: the exact profile's parameter names and shapes (one checkpoint for
    both; JAX's tree fills either), the interior ResnetBlock 3x3 convs in int8 and nothing else, and on the
    same weights within relative L2 1e-3 of JAX's int8 UNet and 0 < rel < 0.25 from the exact output."""
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 32, 32, 2), jnp.float32)
    g = jnp.array([0.5, 0.9])
    params = flax_random_params(j_unet.ResDiffUNet(**UNET), (x, g), seed=8)
    want_q = np.asarray(jax.jit(j_unet.ResDiffUNet(conv_int8=True, **UNET).apply)(params, x, g))
    exact = t_unet.ResDiffUNet(**UNET, device="cpu")
    quant = t_unet.ResDiffUNet(conv_int8=True, **UNET, device="cpu")
    assert [(k, p.shape) for k, p in exact.named_parameters()] == [(k, p.shape) for k, p in quant.named_parameters()]
    assert flax_named(exact, params).keys() == flax_named(quant, params).keys()
    load_flax_params(exact, params)
    load_flax_params(quant, params)
    int8 = [n for n, m in quant.named_modules() if isinstance(m, PlainConvInt8)]
    assert int8 and all(".ConvBlock_" in n and n.endswith(".Conv_0") and n.startswith("ResnetBlockWithAttn_")
                        for n in int8)
    assert not any(isinstance(m, PlainConvInt8) for m in exact.modules())
    tx, tg = _nchw(np.asarray(x)), torch.from_numpy(np.array(g))
    with torch.no_grad():
        y, yq = exact(tx, tg).permute(0, 2, 3, 1).numpy(), quant(tx, tg).permute(0, 2, 3, 1).numpy()
    vs_jax = np.linalg.norm(yq - want_q) / np.linalg.norm(want_q)
    print(f"int8 UNet, port against JAX: relative L2 {vs_jax:.3e}")
    assert vs_jax <= 1e-3, vs_jax
    rel = np.linalg.norm(yq - y) / np.linalg.norm(y)
    assert 0.0 < rel < 0.25, rel
