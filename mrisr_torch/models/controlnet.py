"""ControlNet for the SD1.5 UNet (port of ``mrisr_tpu/models/controlnet.py``), NCHW.

A copy of the UNet's down and mid tower, a small conv pyramid that embeds the
pixel condition image at the latent resolution, and zero-initialised 1x1
output convs (one per skip and one for the mid block) scaled by
``conditioning_scale``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.sd_layers import Conv2d
from mrisr_torch.models.sd_unet import build_down_tower, skip_channels, time_embedding


class ControlNetConditioningEmbedding(nn.Module):
    """Condition-image encoder: 3 channels at full resolution -> ``out_channels`` at the latent resolution."""

    def __init__(self, in_channels: int = 3, out_channels: int = 320,
                 block_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        bc = list(block_channels)
        self.stages = len(bc) - 1
        self.conv_in = Conv2d(in_channels, bc[0], 3, padding=1)
        for i in range(self.stages):
            self.add_module(f"blocks_{2 * i}", Conv2d(bc[i], bc[i], 3, padding=1))
            self.add_module(f"blocks_{2 * i + 1}", Conv2d(bc[i], bc[i + 1], 3, stride=2, padding=1))
        self.conv_out = Conv2d(bc[-1], out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for i in range(2 * self.stages):
            h = F.silu(getattr(self, f"blocks_{i}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """``forward(x, t, context, cond_image | cond_embedding) -> (down residuals, mid residual)``; built on
    ``device`` (CUDA by default)."""

    def __init__(
        self,
        in_channels: int = 4,
        cond_channels: int = 3,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        heads: int = 8,
        context_dim: int = 768,
        conditioning_scale: float = 1.0,
        cond_block_channels: Sequence[int] = (16, 32, 96, 256),
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block, self.heads, self.context_dim = layers_per_block, heads, context_dim
        self.conditioning_scale = conditioning_scale
        ch = list(block_out_channels)
        with dev:
            build_down_tower(self, in_channels, ch, layers_per_block, heads, context_dim)
            self.controlnet_cond_embedding = ControlNetConditioningEmbedding(cond_channels, ch[0],
                                                                             cond_block_channels)
            for i, c in enumerate(skip_channels(ch, layers_per_block)):
                self.add_module(f"controlnet_down_blocks_{i}", Conv2d(c, c, 1))
            self.controlnet_mid_block = Conv2d(ch[-1], ch[-1], 1)
            self.n_skips = len(skip_channels(ch, layers_per_block))
            for name in [f"controlnet_down_blocks_{i}" for i in range(self.n_skips)] + ["controlnet_mid_block"]:
                nn.init.zeros_(getattr(self, name).weight)
                nn.init.zeros_(getattr(self, name).bias)
        self.eval()

    def forward(
        self,
        x: torch.Tensor,  # [B, 4, h, w] latents
        t: torch.Tensor,  # [B]
        context: torch.Tensor,  # [B, L, context_dim]
        cond_image: torch.Tensor | None = None,  # [B, 3, 8h, 8w] pixel condition
        cond_embedding: torch.Tensor | None = None,  # embed_condition's output, computed once a chain
    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        n = len(self.block_out_channels)
        temb = time_embedding(self, t, x.dtype)
        if cond_embedding is None:
            cond_embedding = self.controlnet_cond_embedding(cond_image)
        h = self.conv_in(x) + cond_embedding
        skips = [h]
        for i in range(n):
            block = getattr(self, f"down_blocks_{i}")
            h, res = block(h, temb, context) if i < n - 1 else block(h, temb)
            skips.extend(res)
        h = self.mid_block(h, temb, context)
        s = self.conditioning_scale
        down = [getattr(self, f"controlnet_down_blocks_{i}")(skip) * s for i, skip in enumerate(skips)]
        return down, self.controlnet_mid_block(h) * s


def embed_condition(cn: ControlNet, cond_image: torch.Tensor) -> torch.Tensor:
    """Only the condition-image pyramid (step-invariant: a sampler computes it once a chain)."""
    return cn.controlnet_cond_embedding(cond_image)
