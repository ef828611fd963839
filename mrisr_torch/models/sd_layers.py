"""Stable-Diffusion-1.5 building blocks (port of ``mrisr_tpu/models/sd_layers.py``), NCHW.

Submodules carry the Flax names (``norm1``, ``conv1``, ``time_emb_proj``,
``to_q``, ``transformer_blocks_0``, ``net_0`` ...), so
``mrisr_torch/weights.py`` walks a Flax param tree onto them name for name.
The numerics are the reference's, which differ from diffusers' in two
places: the feed-forward's GEGLU uses tanh-approximate GELU (Flax's
``nn.gelu`` default) and the transformer blocks' LayerNorms have eps 1e-6
(Flax's default).

Every layer computes in the promoted dtype of its input and parameters, as
Flax's do: bf16 weights meet the fp32 latent carry of a bf16 chain in fp32,
and bf16 inputs (the VAE encoder's, the condition's, the prompt's) in bf16.
``Conv2d``, ``Linear`` and ``LayerNorm`` here are ``nn``'s with that rule;
the latent modules build theirs from them.

Every GroupNorm followed by SiLU (the two heads of a ``ResnetBlock2D`` and
the ``conv_norm_out`` of the UNet, ControlNet and VAE) goes through
:func:`gn_silu`, the fused GroupNorm+SiLU kernel; the GroupNorms without
SiLU (``Transformer2D``, ``VAEAttention``) are plain ``torch.group_norm``.
Attention is dense up to 4096 keys and otherwise goes through
``ops/attention.py::spatial_attention`` (the flash-attention kernel on a
CUDA tensor).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.models.layers import _tokens_to_nchw, nearest_up2
from mrisr_torch.ops.attention import dense_attention, spatial_attention
from mrisr_torch.ops.groupnorm import group_norm_silu

DENSE_MAX_KEYS = 4096  # attention over more keys goes through spatial_attention (the flash kernel)


def gn_groups(channels: int, groups: int = 32) -> int:
    """32 groups at real SD sizes; gcd fallback so tiny test configs work."""
    return groups if channels % groups == 0 else math.gcd(channels, groups)


def _promote(x: torch.Tensor, *params: torch.Tensor | None) -> list[torch.Tensor | None]:
    """``x`` and ``params`` in their promoted dtype, as Flax's layers compute (a bf16 weight meets an fp32
    input in fp32; upcasting it is exact).  A tensor already in that dtype is returned as it is."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return [None if t is None else t.to(dt) for t in (x, *params)]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in the promoted dtype of its input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_promote(x, self.weight, self.bias))


class Linear(nn.Linear):
    """``nn.Linear`` computed in the promoted dtype of its input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in the promoted dtype of its input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def gn_silu(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """SiLU(``norm``(x)) through the fused GroupNorm+SiLU kernel, in the promoted dtype."""
    return group_norm_silu(*_promote(x, norm.weight, norm.bias), norm.num_groups, norm.eps)


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """``norm(x)`` in the promoted dtype; ``torch.group_norm`` also takes a group of one element (see
    ``group_norm_silu_plain``)."""
    x, w, b = _promote(x, norm.weight, norm.bias)
    return torch.group_norm(x, norm.num_groups, w, b, norm.eps)


class Timesteps(nn.Module):
    """Diffusers sinusoidal timestep projection (flip_sin_to_cos=True), float32 ``[B] -> [B, dim]``."""

    def __init__(self, dim: int, flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0):
        super().__init__()
        self.dim, self.flip_sin_to_cos, self.downscale_freq_shift = dim, flip_sin_to_cos, downscale_freq_shift

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
        emb = torch.exp(exponent / (half - self.downscale_freq_shift))
        emb = t.float()[:, None] * emb[None, :]
        sin, cos = torch.sin(emb), torch.cos(emb)
        return torch.cat([cos, sin] if self.flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2 (float32 from ``Timesteps``)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """Diffusers ResnetBlock2D: (GN+SiLU, conv) twice with temb injection; both heads are the fused kernel."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32, eps: float = 1e-5,
                 temb_channels: int | None = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(gn_groups(in_channels, groups), in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(gn_groups(out_channels, groups), out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(gn_silu(x, self.norm1))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(gn_silu(h, self.norm2))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention on tokens ``[B, N, C]``, self or cross (``context``)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int, out_dim: int, context_dim: int | None = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = Linear(inner, out_dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        return self.to_out(attend(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads, self.head_dim))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """Multi-head attention of projected tokens ``[B, N, heads * head_dim]`` (keys ``[B, M, ...]``): dense up to
    ``DENSE_MAX_KEYS`` keys, else :func:`spatial_attention`."""
    b, n, inner = q.shape
    m = k.shape[1]
    if m > DENSE_MAX_KEYS:
        return spatial_attention(q, k, v, heads)

    def split(t, length):
        return t.reshape(b, length, heads, head_dim).transpose(1, 2).reshape(b * heads, length, head_dim)

    out = dense_attention(split(q, n), split(k, m), split(v, m), 1.0 / math.sqrt(head_dim))
    return out.reshape(b, heads, n, head_dim).transpose(1, 2).reshape(b, n, inner)


class GEGLU(nn.Module):
    """``h * gelu(gate)`` with tanh-approximate GELU, as the reference's Flax ``nn.gelu``."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult)
        self.net_2 = Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU feed-forward; pre-LayerNorm (eps 1e-6)."""

    def __init__(self, dim: int, heads: int, context_dim: int = 768):
        super().__init__()
        head_dim = dim // heads
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, head_dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, head_dim, dim, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GroupNorm (eps 1e-6, no SiLU) and 1x1 projections in and out around the blocks."""

    def __init__(self, channels: int, heads: int, depth: int = 1, context_dim: int = 768):
        super().__init__()
        self.norm = nn.GroupNorm(gn_groups(channels), channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        for i in range(depth):
            self.add_module(f"transformer_blocks_{i}", BasicTransformerBlock(channels, heads, context_dim))
        self.depth = depth
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(_group_norm(x, self.norm)).flatten(2).transpose(1, 2)  # [B, HW, C]
        for i in range(self.depth):
            y = getattr(self, f"transformer_blocks_{i}")(y, context)
        return self.proj_out(_tokens_to_nchw(y, h, w)) + x


class Downsample2D(nn.Module):
    """3x3 stride-2 conv, padding 1 on every side."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_up2(x))


class VAEAttention(nn.Module):
    """Single-head VAE mid-block attention (diffusers AttnBlock), always dense, width C."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(gn_groups(channels), channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = _group_norm(x, self.group_norm).flatten(2).transpose(1, 2)  # [B, HW, C]
        out = dense_attention(self.to_q(y), self.to_k(y), self.to_v(y), 1.0 / math.sqrt(c))
        return x + _tokens_to_nchw(self.to_out(out), h, w)
