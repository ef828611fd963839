"""Small time-conditioned UNet for the MNIST 14->28 toy SR task (port of ``mrisr_tpu/models/mnist_unet.py``).

Two modes, as in the reference:

* regression: ``model(upsample(lr))`` -> HR directly (``t`` and ``y`` None:
  no embedding, the blocks' ``Dense_0`` unused);
* ddpm: ``model(concat(x_t, upsample(lr)), t, y)`` -> predicted noise, with
  optional class labels.

NCHW.  Submodules carry the Flax auto-names in the reference's creation
order (``Dense_0``, ``Embed_0``, ``Conv_0``, ``ResnetBlock_0`` ... ``_6``,
``Downsample_0/1``, ``Upsample_0/1``, ``GroupNorm_0``, ``Conv_1``), so
``weights.load_flax_params`` carries a Flax ``MNISTUNet`` across.  Every
GroupNorm -> swish, the final one included, runs through the fused kernel.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.layers import GN_EPS, Downsample, ResnetBlock, SinusoidalTimeEmbedding, Upsample
from mrisr_torch.ops.groupnorm import group_norm_silu


class MNISTUNet(nn.Module):
    def __init__(
        self,
        channels: Sequence[int] = (32, 64, 128),
        time_dim: int = 64,
        out_channels: int = 1,
        num_classes: int = 0,  # 0 = unconditional
        groups: int = 8,
        in_channels: int = 1,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        ch = list(channels)
        self.groups, self.num_classes = groups, num_classes
        self.SinusoidalTimeEmbedding_0 = SinusoidalTimeEmbedding(time_dim)
        self.Dense_0 = nn.Linear(time_dim, time_dim)
        if num_classes > 0:
            self.Embed_0 = nn.Embedding(num_classes, time_dim)
        self.Conv_0 = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        blocks, downs, ups = [], [], []
        prev, skips = ch[0], []
        for i, c in enumerate(ch):
            blocks.append(ResnetBlock(prev, c, groups, time_dim))
            prev = c
            skips.append(c)
            if i != len(ch) - 1:
                downs.append(Downsample(c))
        blocks.append(ResnetBlock(prev, ch[-1], groups, time_dim))
        for i, c in enumerate(reversed(ch)):
            blocks.append(ResnetBlock(prev + skips.pop(), c, groups, time_dim))
            prev = c
            if i != len(ch) - 1:
                ups.append(Upsample(c))
        for prefix, mods in (("ResnetBlock", blocks), ("Downsample", downs), ("Upsample", ups)):
            for i, m in enumerate(mods):
                self.add_module(f"{prefix}_{i}", m)
        self.n_levels = len(ch)
        self.GroupNorm_0 = nn.GroupNorm(groups, ch[0], eps=GN_EPS)
        self.Conv_1 = nn.Conv2d(ch[0], out_channels, 3, padding=1)
        self.to(dev)

    def embedding(self, t: torch.Tensor | None, y: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
        """The time (and class) embedding ``[B, time_dim]`` in ``dtype``; None without ``t`` and ``y``."""
        emb = None
        if t is not None:
            emb = F.relu(self.Dense_0(self.SinusoidalTimeEmbedding_0(t)))
        if y is not None and self.num_classes > 0:
            cls = self.Embed_0(y.long())
            emb = cls if emb is None else emb + cls
        return None if emb is None else emb.to(dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor | None = None, y: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        emb = self.embedding(t, y, x.dtype)
        n = self.n_levels
        block = iter(getattr(self, f"ResnetBlock_{i}") for i in range(2 * n + 1))
        h = self.Conv_0(x)
        skips = []
        for i in range(n):
            h = next(block)(h, emb, generator)
            skips.append(h)
            if i != n - 1:
                h = getattr(self, f"Downsample_{i}")(h)
        h = next(block)(h, emb, generator)
        for i in range(n):
            h = next(block)(torch.cat([h, skips.pop()], dim=1), emb, generator)
            if i != n - 1:
                h = getattr(self, f"Upsample_{i}")(h)
        gn = self.GroupNorm_0
        return self.Conv_1(group_norm_silu(h, gn.weight, gn.bias, self.groups, gn.eps))
