"""AutoencoderKL, the SD1.5 VAE (port of ``mrisr_tpu/models/vae.py``), NCHW.

4-stage encoder and decoder with (128, 256, 512, 512) channels, 2 (encoder)
and 3 (decoder) resnets a stage, single-head mid attention, a diagonal
Gaussian posterior and scaling factor 0.18215.  GroupNorm eps is 1e-6
throughout; every ResnetBlock2D head and both ``conv_norm_out`` go through
the fused GroupNorm+SiLU kernel.  ``encode`` samples the posterior with a
noise tensor the caller draws.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.sd_layers import Conv2d, Downsample2D, ResnetBlock2D, Upsample2D, VAEAttention, gn_groups, gn_silu

SD15_SCALING_FACTOR = 0.18215
_VAE_EPS = 1e-6


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 2, add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for j in range(num_layers):
            self.add_module(f"resnets_{j}", ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels,
                                                          eps=_VAE_EPS))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.num_layers):
            x = getattr(self, f"resnets_{j}")(x)
        return self.downsamplers_0(x) if hasattr(self, "downsamplers_0") else x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3, add_upsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for j in range(num_layers):
            self.add_module(f"resnets_{j}", ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels,
                                                          eps=_VAE_EPS))
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.num_layers):
            x = getattr(self, f"resnets_{j}")(x)
        return self.upsamplers_0(x) if hasattr(self, "upsamplers_0") else x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, eps=_VAE_EPS)
        self.attentions_0 = VAEAttention(channels)
        self.resnets_1 = ResnetBlock2D(channels, channels, eps=_VAE_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets_1(self.attentions_0(self.resnets_0(x)))


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)
        self.stages = len(ch)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)
        prev = ch[0]
        for i, c in enumerate(ch):
            self.add_module(f"down_blocks_{i}", DownEncoderBlock(prev, c, layers_per_block, i != len(ch) - 1))
            prev = c
        self.mid_block = VAEMidBlock(ch[-1])
        self.conv_norm_out = nn.GroupNorm(gn_groups(ch[-1]), ch[-1], eps=_VAE_EPS)
        self.conv_out = Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.stages):
            h = getattr(self, f"down_blocks_{i}")(h)
        h = self.mid_block(h)
        return self.conv_out(gn_silu(h, self.conv_norm_out))


class Decoder(nn.Module):
    def __init__(self, latent_channels: int = 4, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, out_channels: int = 3):
        super().__init__()
        ch = list(reversed(block_out_channels))  # (512, 512, 256, 128)
        self.stages = len(ch)
        self.conv_in = Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block = VAEMidBlock(ch[0])
        prev = ch[0]
        for i, c in enumerate(ch):
            self.add_module(f"up_blocks_{i}", UpDecoderBlock(prev, c, layers_per_block, i != len(ch) - 1))
            prev = c
        self.conv_norm_out = nn.GroupNorm(gn_groups(ch[-1]), ch[-1], eps=_VAE_EPS)
        self.conv_out = Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for i in range(self.stages):
            h = getattr(self, f"up_blocks_{i}")(h)
        return self.conv_out(gn_silu(h, self.conv_norm_out))


class AutoencoderKL(nn.Module):
    """Encoder, decoder and the two 1x1 quant convs; built on ``device`` (CUDA by default)."""

    def __init__(
        self,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        latent_channels: int = 4,
        in_channels: int = 3,
        scaling_factor: float = SD15_SCALING_FACTOR,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.scaling_factor = scaling_factor
        self.downsample_factor = 2 ** (len(block_out_channels) - 1)  # pixels a latent spans, each way
        with dev:
            self.encoder = Encoder(in_channels, block_out_channels, 2, latent_channels)
            self.decoder = Decoder(latent_channels, block_out_channels, 3, in_channels)
            self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
            self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)
        self.eval()

    def encode_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the posterior; logvar clipped to [-30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        """A posterior sample ``mean + exp(logvar / 2) * noise``; the mean when ``noise`` is None."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        return self.decode(self.encode(x, noise))
