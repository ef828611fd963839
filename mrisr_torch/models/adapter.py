"""T2I-Adapter, Adapter_XL shape (port of ``mrisr_tpu/models/adapter.py``), NCHW.

PixelUnshuffle(8) on the condition image, ``conv_in`` to 320 channels, then
4 stages of 3 plain ResNet blocks with a stride-2 conv at the start of
stages 1-3; one feature map per stage (320, 640, 1280, 1280) for the UNet's
down blocks.  ``zero_out`` adds a zero-initialised 1x1 projection on each
feature map (the reference's disclosed addition).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.sd_layers import Conv2d


class AdapterResnetBlock(nn.Module):
    """in_conv, then (conv3x3, relu, conv) plus a skip conv of in_conv's output."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3):
        super().__init__()
        p = ksize // 2
        self.in_conv = Conv2d(in_channels, out_channels, ksize, padding=p)
        self.block1 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.block2 = Conv2d(out_channels, out_channels, ksize, padding=p)
        self.skep = Conv2d(out_channels, out_channels, ksize, padding=p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in = self.in_conv(x)
        return self.block2(F.relu(self.block1(x_in))) + self.skep(x_in)


class T2IAdapter(nn.Module):
    """``forward(cond [B, 3, H, W]) -> [feature of each stage]``; built on ``device`` (CUDA by default)."""

    def __init__(
        self,
        channels: Sequence[int] = (320, 640, 1280, 1280),
        num_res_blocks: int = 3,
        cin: int = 192,  # 3 channels x 8^2 after the unshuffle
        ksize: int = 3,
        unshuffle_factor: int = 8,
        zero_out: bool = False,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.channels, self.num_res_blocks = tuple(channels), num_res_blocks
        self.unshuffle_factor, self.zero_out = unshuffle_factor, zero_out
        with dev:
            self.conv_in = Conv2d(cin, channels[0], 3, padding=1)
            prev = channels[0]
            for i, c in enumerate(channels):
                for j in range(num_res_blocks):
                    if i > 0 and j == 0:  # the downsample keeps its input's channels
                        self.add_module(f"body_{i}_{j}_down", Conv2d(prev, prev, 3, stride=2, padding=1))
                    self.add_module(f"body_{i}_{j}", AdapterResnetBlock(prev, c, ksize))
                    prev = c
                if zero_out:
                    proj = Conv2d(c, c, 1)
                    nn.init.zeros_(proj.weight)
                    nn.init.zeros_(proj.bias)
                    self.add_module(f"out_proj_{i}", proj)
        self.eval()

    def forward(self, cond: torch.Tensor) -> list[torch.Tensor]:
        x = self.conv_in(F.pixel_unshuffle(cond, self.unshuffle_factor))
        features = []
        for i in range(len(self.channels)):
            for j in range(self.num_res_blocks):
                if i > 0 and j == 0:
                    x = getattr(self, f"body_{i}_{j}_down")(x)
                x = getattr(self, f"body_{i}_{j}")(x)
            features.append(getattr(self, f"out_proj_{i}")(x) if self.zero_out else x)
        return features
