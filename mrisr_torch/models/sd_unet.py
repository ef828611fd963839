"""SD1.5-class conditional UNet (port of ``mrisr_tpu/models/sd_unet.py``), NCHW.

4 down / 1 mid / 4 up blocks, channels (320, 640, 1280, 1280), 2 resnets per
down block and 3 per up block, 8-head cross-attention to a 768-wide text
context.  ControlNet residuals (``down_block_additional_residuals``,
``mid_block_additional_residual``) and T2I-Adapter features
(``adapter_features``) add in at the reference's points.  Submodules carry
the Flax names, so ``weights.load_flax_params`` fills them.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.sd_layers import (
    Conv2d,
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Timesteps,
    Transformer2D,
    Upsample2D,
    gn_groups,
    gn_silu,
)


class CrossAttnDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, heads: int, temb_channels: int, layers: int = 2,
                 add_downsample: bool = True, context_dim: int = 768):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resnets_{i}", ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                                                          temb_channels=temb_channels))
            self.add_module(f"attentions_{i}", Transformer2D(out_channels, heads, context_dim=context_dim))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_channels)

    def forward(self, x, temb, context, adapter_feat=None):
        residuals = []
        for i in range(self.layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            x = getattr(self, f"attentions_{i}")(x, context)
            if adapter_feat is not None and i == self.layers - 1:
                x = x + adapter_feat
            residuals.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            residuals.append(x)
        return x, residuals


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, layers: int = 2,
                 add_downsample: bool = False):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resnets_{i}", ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                                                          temb_channels=temb_channels))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_channels)

    def forward(self, x, temb, adapter_feat=None):
        residuals = []
        for i in range(self.layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if adapter_feat is not None and i == self.layers - 1:
                x = x + adapter_feat
            residuals.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            residuals.append(x)
        return x, residuals


class MidBlock(nn.Module):
    def __init__(self, channels: int, heads: int, temb_channels: int, context_dim: int = 768):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, temb_channels=temb_channels)
        self.attentions_0 = Transformer2D(channels, heads, context_dim=context_dim)
        self.resnets_1 = ResnetBlock2D(channels, channels, temb_channels=temb_channels)

    def forward(self, x, temb, context):
        x = self.resnets_0(x, temb)
        x = self.attentions_0(x, context)
        return self.resnets_1(x, temb)


class UpBlock(nn.Module):
    """Each layer concatenates the next skip (popped from the end) before its resnet."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int], out_channels: int, temb_channels: int,
                 add_upsample: bool = True, heads: int | None = None, context_dim: int = 768):
        super().__init__()
        self.layers = len(skip_channels)
        for i, s in enumerate(skip_channels):
            self.add_module(f"resnets_{i}", ResnetBlock2D((in_channels if i == 0 else out_channels) + s,
                                                          out_channels, temb_channels=temb_channels))
            if heads is not None:
                self.add_module(f"attentions_{i}", Transformer2D(out_channels, heads, context_dim=context_dim))
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_channels)

    def forward(self, x, skips, temb, context=None):
        for i in range(self.layers):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"resnets_{i}")(x, temb)
            if hasattr(self, f"attentions_{i}"):
                x = getattr(self, f"attentions_{i}")(x, context)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class CrossAttnUpBlock(UpBlock):
    """An :class:`UpBlock` with a ``Transformer2D`` after each resnet."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int], out_channels: int, heads: int,
                 temb_channels: int, add_upsample: bool = True, context_dim: int = 768):
        super().__init__(in_channels, skip_channels, out_channels, temb_channels, add_upsample, heads, context_dim)


def skip_channels(block_out_channels: Sequence[int], layers_per_block: int) -> list[int]:
    """Channels of the down path's skips in the order they are pushed: conv_in, then each down block's
    resnets and its downsample (every block but the last)."""
    ch = list(block_out_channels)
    out = [ch[0]]
    for i, c in enumerate(ch):
        out += [c] * layers_per_block + ([c] if i < len(ch) - 1 else [])
    return out


def build_down_tower(module: nn.Module, in_channels: int, block_out_channels, layers_per_block: int, heads: int,
                     context_dim: int) -> None:
    """The modules the UNet and the ControlNet share: time embedding, ``conv_in``, the down blocks and the
    mid block."""
    ch = list(block_out_channels)
    temb = ch[0] * 4
    module.time_proj = Timesteps(ch[0])
    module.time_embedding = TimestepEmbedding(ch[0], temb)
    module.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
    prev = ch[0]
    for i, c in enumerate(ch):
        if i < len(ch) - 1:
            block = CrossAttnDownBlock(prev, c, heads, temb, layers_per_block, True, context_dim)
        else:
            block = DownBlock(prev, c, temb, layers_per_block, False)
        module.add_module(f"down_blocks_{i}", block)
        prev = c
    module.mid_block = MidBlock(ch[-1], heads, temb, context_dim)


def time_embedding(module: nn.Module, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float32 timestep embedding, cast to the activations' dtype (as the reference casts it)."""
    return module.time_embedding(module.time_proj(t)).to(dtype)


class SDUNet(nn.Module):
    """UNet2DConditionModel, SD1.5 configuration by default; built on ``device`` (CUDA by default)."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        heads: int = 8,
        context_dim: int = 768,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        ch = list(block_out_channels)
        temb = ch[0] * 4
        with dev:
            build_down_tower(self, in_channels, ch, layers_per_block, heads, context_dim)
            skips = skip_channels(ch, layers_per_block)
            rev = list(reversed(ch))
            prev = ch[-1]
            for i, c in enumerate(rev):
                taken = [skips.pop() for _ in range(layers_per_block + 1)]
                last = i == len(rev) - 1
                block = (UpBlock(prev, taken, c, temb, not last) if i == 0
                         else CrossAttnUpBlock(prev, taken, c, heads, temb, not last, context_dim))
                self.add_module(f"up_blocks_{i}", block)
                prev = c
            self.conv_norm_out = nn.GroupNorm(gn_groups(ch[0]), ch[0], eps=1e-5)
            self.conv_out = Conv2d(ch[0], out_channels, 3, padding=1)
        self.eval()

    def forward(
        self,
        x: torch.Tensor,  # [B, C, h, w] latents
        t: torch.Tensor,  # [B] timesteps
        context: torch.Tensor,  # [B, L, context_dim] text embeddings
        down_block_additional_residuals: Sequence[torch.Tensor] | None = None,
        mid_block_additional_residual: torch.Tensor | None = None,
        adapter_features: Sequence[torch.Tensor] | None = None,
    ) -> torch.Tensor:
        n = len(self.block_out_channels)
        temb = time_embedding(self, t, x.dtype)
        h = self.conv_in(x)
        skips = [h]
        feats = adapter_features or [None] * n
        for i in range(n):
            block = getattr(self, f"down_blocks_{i}")
            if i < n - 1:
                h, res = block(h, temb, context, feats[i])
            else:
                h, res = block(h, temb, feats[i])
            skips.extend(res)
        if down_block_additional_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_block_additional_residuals)]
        h = self.mid_block(h, temb, context)
        if mid_block_additional_residual is not None:
            h = h + mid_block_additional_residual
        for i in range(n):
            h = getattr(self, f"up_blocks_{i}")(h, skips, temb, context)
        return self.conv_out(gn_silu(h, self.conv_norm_out))
