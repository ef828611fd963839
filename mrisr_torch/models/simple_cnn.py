"""Stage-1 SimpleCNN (port of ``mrisr_tpu/models/simple_cnn.py``), NCHW.

conv(1->64) ReLU, conv(64->32) ReLU, conv(32->s^2) pixel-shuffle, plus the
bicubic-upsampled input as a residual.  The serving chain runs it at s=1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.device import resolve_device


class SimpleCNN(nn.Module):
    """``[B, C, H, W] -> [B, C, H*s, W*s]``; built on ``device`` (CUDA by default)."""

    def __init__(
        self,
        scale_factor: int = 1,
        hidden: int = 64,
        channels: int = 1,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.scale_factor = scale_factor
        s = scale_factor
        self.Conv_0 = nn.Conv2d(channels, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, hidden // 2, 3, padding=1)
        self.Conv_2 = nn.Conv2d(hidden // 2, channels * s * s, 3, padding=1)
        self.eval()
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale_factor
        b, c, h, w = x.shape
        if s == 1:
            x_up = x
        else:
            x_up = F.interpolate(x, scale_factor=s, mode="bicubic", align_corners=False)
        y = F.relu(self.Conv_0(x))
        y = F.relu(self.Conv_1(y))
        y = self.Conv_2(y)
        if s > 1:
            # The reference's NHWC pixel shuffle orders channels (i, j, c).
            y = y.reshape(b, s, s, c, h, w).permute(0, 3, 4, 1, 5, 2).reshape(b, c, h * s, w * s)
        return y + x_up
