"""ResDiff building blocks, plain path (port of ``mrisr_tpu/models/layers.py``).

Activations are NCHW.  Submodules carry the Flax names (``GroupNorm_0``,
``Conv_0``, ``Dense_0``, ...) so that ``mrisr_torch/weights.py`` maps a Flax
param tree onto them name for name.  Dropout (the second ``ConvBlock`` of every
``ResnetBlock``) acts in training mode only and draws its masks from the
``torch.Generator`` handed down by the caller, never from the global RNG.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.ops.attention import cross_attention_2d, spatial_attention
from mrisr_torch.ops.groupnorm import group_norm_silu
from mrisr_torch.ops.quant import int8_conv

# torch's nn.GroupNorm default, which the reference ResDiff modules use.
GN_EPS = 1e-5


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` computed in ``x``'s dtype (Flax promotes bf16 params to fp32 inputs)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _conv1x1(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer(x)`` for a 1x1 conv, computed in ``x``'s dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias)


def _tokens_to_nchw(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, H*W, C]`` tokens -> NCHW-contiguous ``[B, C, H, W]``.

    A plain reshape of the transpose would be channels-last in memory, and
    the convolutions after it would carry that layout on to the GN+SiLU
    kernel, which takes NCHW-contiguous input.
    """
    b, _, c = t.shape
    return t.transpose(1, 2).reshape(b, c, h, w).contiguous()


class NoiseLevelEncoding(nn.Module):
    """SR3 continuous noise-level encoding, float32: ``gamma [B] -> [B, dim]``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, gamma: torch.Tensor) -> torch.Tensor:
        count = self.dim // 2
        step = torch.arange(count, dtype=torch.float32, device=gamma.device) / count
        freqs = torch.exp(-math.log(1e4) * step)
        args = gamma.reshape(-1, 1).float() * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalTimeEmbedding(nn.Module):
    """Integer-timestep embedding, float32: ``t [B] -> [B, dim]``,
    ``t * exp(-log(10000) * arange(half) / (half - 1))`` -> sin | cos."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        step = torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1)
        freqs = torch.exp(-math.log(10000.0) * step)
        args = t.reshape(-1, 1).float() * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class NoiseLevelMLP(nn.Module):
    """Encoding -> Dense(4d) -> swish -> Dense(d), computed in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.encoding = NoiseLevelEncoding(dim)
        self.Dense_0 = nn.Linear(dim, dim * 4)
        self.Dense_1 = nn.Linear(dim * 4, dim)

    def forward(self, gamma: torch.Tensor) -> torch.Tensor:
        h = _linear(self.encoding(gamma), self.Dense_0)
        return _linear(F.silu(h), self.Dense_1)


class SEBlock(nn.Module):
    """Squeeze-excite with residual: ``x * sigmoid(fc(relu(fc(gap(x))))) + x``."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        bottleneck = max(1, channels // reduction)
        self.Dense_0 = nn.Linear(channels, bottleneck, bias=False)
        self.Dense_1 = nn.Linear(bottleneck, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(_linear(F.relu(_linear(y, self.Dense_0)), self.Dense_1))
        return x * y[:, :, None, None] + x


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by ``1 / (1 - rate)``."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator on the tensor's device")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class PlainConvInt8(nn.Conv2d):
    """A stride-1 ``"SAME"`` conv computed in dynamic int8 (``ops/quant.py::int8_conv``).  Its parameters are
    ``nn.Conv2d``'s (``weight``, ``bias``), so the exact profile's checkpoint fills it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight, self.bias, self.stride)


class ConvBlock(nn.Module):
    """GroupNorm -> swish -> (dropout) -> 3x3 conv; GN+swish runs through the fused kernel.  ``int8=True``
    runs the conv in dynamic int8 (the int8 serving profile; same parameters)."""

    def __init__(self, in_channels: int, features: int, groups: int = 32, dropout: float = 0.0, int8: bool = False):
        super().__init__()
        self.groups = groups
        self.dropout = dropout
        self.GroupNorm_0 = nn.GroupNorm(groups, in_channels, eps=GN_EPS)
        self.Conv_0 = (PlainConvInt8 if int8 else nn.Conv2d)(in_channels, features, 3, padding=1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        gn = self.GroupNorm_0
        h = group_norm_silu(x, gn.weight, gn.bias, self.groups, gn.eps)
        if self.training and self.dropout > 0.0:
            h = dropout(h, self.dropout, generator)
        return self.Conv_0(h)


class ResnetBlock(nn.Module):
    """SR3 residual block with feature-wise noise-embedding injection.

    ``emb=None`` skips the injection (``Dense_0`` is kept, unused), as the
    reference does for a model called without a timestep or label.
    """

    def __init__(self, in_channels: int, features: int, groups: int, emb_dim: int, dropout: float = 0.0,
                 int8: bool = False):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_channels, features, groups, int8=int8)
        self.Dense_0 = nn.Linear(emb_dim, features)
        self.ConvBlock_1 = ConvBlock(features, features, groups, dropout, int8=int8)
        if in_channels != features:
            self.Conv_0 = nn.Conv2d(in_channels, features, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.ConvBlock_0(x)
        if emb is not None:
            h = h + self.Dense_0(emb)[:, :, None, None]
        h = self.ConvBlock_1(h, generator)
        if hasattr(self, "Conv_0"):
            x = self.Conv_0(x)
        return h + x


class SelfAttention2D(nn.Module):
    """Spatial self-attention over flattened H*W (SR3 mid-block attention)."""

    def __init__(self, channels: int, groups: int = 32, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(channels, channels * 3, 1, bias=False)
        self.Conv_1 = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self.Conv_0(self.GroupNorm_0(x)).flatten(2).transpose(1, 2)  # [B, HW, 3C]
        q, k, v = qkv.chunk(3, dim=-1)
        out = spatial_attention(q, k, v, self.num_heads)
        return self.Conv_1(_tokens_to_nchw(out, h, w)) + x


class ResnetBlockWithAttn(nn.Module):
    def __init__(
        self, in_channels: int, features: int, groups: int, emb_dim: int, with_attn: bool, dropout: float = 0.0,
        int8: bool = False,
    ):
        super().__init__()
        self.ResnetBlock_0 = ResnetBlock(in_channels, features, groups, emb_dim, dropout, int8)
        if with_attn:
            self.SelfAttention2D_0 = SelfAttention2D(features, groups)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.ResnetBlock_0(x, emb, generator)
        if hasattr(self, "SelfAttention2D_0"):
            x = self.SelfAttention2D_0(x)
        return x


class Downsample(nn.Module):
    """3x3 stride-2 conv (SR3 convention)."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of NCHW ``x`` via broadcast/reshape."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, h * 2, w * 2)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv (SR3 convention)."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(nearest_up2(x))


class HFGuidedCrossAttention(nn.Module):
    """Wavelet-guided cross-attention (the reference's plain path).

    Query: the 1-channel band-pass map lifted to C channels by a 1x1 conv.
    Key/value: 1x1 conv of the GroupNorm'd feature map.  Single-head spatial
    attention with 1/sqrt(C) scaling, output projection, residual.
    ``kv_pool >= 2`` (fast serving profile): K/V come from the
    ``kv_pool x kv_pool`` average-pooled normalized map.
    """

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(channels, channels * 2, 1, bias=False)
        self.Conv_1 = nn.Conv2d(1, channels, 1, bias=False)
        self.Conv_2 = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, query_map: torch.Tensor, kv_pool: int = 0) -> torch.Tensor:
        b, c, h, w = x.shape
        n = self.GroupNorm_0(x)
        p = int(kv_pool) if kv_pool else 0
        if p > 1 and h % p == 0 and w % p == 0:
            n = F.avg_pool2d(n, p, p)
        k, v = self.Conv_0(n).flatten(2).transpose(1, 2).chunk(2, dim=-1)  # [B, M, C] each
        q = self.Conv_1(query_map).flatten(2).transpose(1, 2)  # [B, N, C]
        out = cross_attention_2d(q, k, v)
        return self.Conv_2(_tokens_to_nchw(out, h, w)) + x
