"""Grayscale ResDiff UNet, plain path (port of ``mrisr_tpu/models/resdiff_unet.py``).

NCHW throughout.  ``ResDiffUNet`` takes ``x = cat([cnn_sr, x_t])`` on
channels ``[B, 2, H, W]`` and the continuous noise level ``gamma [B]``, and
returns eps ``[B, 1, H, W]``.  The space-to-depth execution form of the
reference is a TPU layout rewrite with the same math and is not ported.
``conv_int8=True`` is the int8 serving profile: the interior ResnetBlock 3x3
convs run in dynamic int8 (``ops/quant.py``); ``conv_in``, the final
ConvBlock, the 1x1 shortcuts and the resample convs stay exact, and the
parameters are the same, so one checkpoint serves every profile.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.layers import (
    ConvBlock,
    Downsample,
    HFGuidedCrossAttention,
    NoiseLevelMLP,
    ResnetBlockWithAttn,
    SEBlock,
    Upsample,
    _conv1x1,
)
from mrisr_torch.ops.fourier import gaussian_highpass_split
from mrisr_torch.ops.wavelets import haar_dwt_highpass_sum


class FDInfoSpliter(nn.Module):
    """Frequency-domain information splitter: ``[B, 2, H, W] -> [B, 5, H, W]``.

    Output channels: ``[x_t, cnn_sr, denoise_x, x_lf, x_hf]``.  The FFT branch
    depends only on the stage-1 estimate; samplers compute it once per chain
    with :meth:`static_features` and pass it as ``static``.
    """

    def __init__(self, emb_dim: int, image_size: int, reduction: int = 2):
        super().__init__()
        self.image_size = image_size
        self.noise_func = nn.Linear(emb_dim, image_size)
        self.noise_resSE = SEBlock(1, reduction)
        self.sigma_resSE = SEBlock(2, reduction)
        self.HF_guided_resSE = SEBlock(2, reduction)
        self.channel_transform = nn.Conv2d(2, 1, 1)

    def static_features(self, cnn_x: torch.Tensor):
        """``cnn_x`` [B, 1, H, W] -> (x_lf, x_hf), each [B, 1, H, W]."""
        xf = torch.fft.fft2(cnn_x[:, 0].float())  # [B, H, W], FFT over (H, W) per image
        x_fd = torch.stack([xf.real, xf.imag], dim=1)  # [B, 2, H, W]

        # Learned sigma: |mean over channels of the SE-pooled map| + size/2,
        # clamped to size - 10.
        pooled = self.sigma_resSE(x_fd).mean(dim=(2, 3))  # [B, 2]
        sigma_pre = pooled.mean(dim=-1).abs() + self.image_size / 2.0
        sigma = sigma_pre.clamp(max=float(self.image_size - 10))

        xf_filtered, hf_abs = gaussian_highpass_split(cnn_x, sigma[:, None])
        x_fd_filtered = torch.stack([xf_filtered[:, 0].real, xf_filtered[:, 0].imag], dim=1)
        atten = _conv1x1(self.HF_guided_resSE(x_fd_filtered), self.channel_transform)
        x_lf = (cnn_x.float() * atten).to(cnn_x.dtype)
        x_hf = hf_abs.to(cnn_x.dtype)
        return x_lf, x_hf

    def forward(self, x: torch.Tensor, noise_emb: torch.Tensor, static=None) -> torch.Tensor:
        cnn_x = x[:, 0:1]
        xt = x[:, 1:2]
        b, _, h, _ = x.shape
        # Noise-image suppression: one row per image, varying along W.
        row = self.noise_func(noise_emb)  # [B, W]
        noise_img = row[:, None, None, :].expand(b, 1, h, self.image_size)
        denoise_x = xt * self.noise_resSE(noise_img)
        x_lf, x_hf = self.static_features(cnn_x) if static is None else static
        return torch.cat([xt, cnn_x, denoise_x, x_lf, x_hf], dim=1)


class ResDiffUNet(nn.Module):
    """SR3 backbone + FD splitter + DWT-guided skip cross-attention.

    Defaults are the serving configuration: 256^2, inner 32, mults (1,2,4,4),
    one res-block per level, GroupNorm(16), mid self-attention only.
    ``ca_kv_pool >= 2`` is the fast serving profile (K/V pooled at the CA
    sites with at least ``ca_kv_pool_min_tokens`` tokens); 0 is exact.
    The module is built on ``device`` (CUDA by default; raises if absent) and
    comes up in eval mode; after ``.train()`` every ResnetBlock applies
    ``dropout`` with masks drawn from ``forward``'s ``generator``.
    """

    def __init__(
        self,
        image_size: int = 256,
        inner_channel: int = 32,
        channel_mults: Sequence[int] = (1, 2, 4, 4),
        res_blocks: int = 1,
        attn_res: Sequence[int] = (8,),
        norm_groups: int = 16,
        dropout: float = 0.2,
        out_channels: int = 1,
        ca_kv_pool: int = 0,
        ca_kv_pool_min_tokens: int = 4096,
        conv_int8: bool = False,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.image_size = image_size
        self.channel_mults = tuple(channel_mults)
        self.res_blocks = res_blocks
        self.ca_kv_pool = ca_kv_pool
        self.ca_kv_pool_min_tokens = ca_kv_pool_min_tokens
        self.conv_int8 = conv_int8
        self.attn_res = tuple(attn_res)
        inner, groups = inner_channel, norm_groups
        n_levels = len(self.channel_mults)

        self.NoiseLevelMLP_0 = NoiseLevelMLP(inner)
        self.fd_spliter = FDInfoSpliter(inner, image_size)
        self.conv_in = nn.Conv2d(5, inner, 3, padding=1)

        # Channel bookkeeping mirrors the reference's traversal, so the Flax
        # auto-names (ResnetBlockWithAttn_<i> etc.) line up one for one.
        rba = 0

        def add_rba(cin, cout, attn):
            nonlocal rba
            self.add_module(f"ResnetBlockWithAttn_{rba}", ResnetBlockWithAttn(cin, cout, groups, inner, attn, dropout,
                                                                            conv_int8))
            rba += 1

        pre, now_res, feat_ch = inner, image_size, [inner]
        for i, mult in enumerate(self.channel_mults):
            ch = inner * mult
            for _ in range(res_blocks):
                add_rba(pre, ch, now_res in attn_res)
                feat_ch.append(ch)
                pre = ch
            if i != n_levels - 1:
                self.add_module(f"Downsample_{i}", Downsample(pre))
                self.add_module(f"HFGuidedCrossAttention_{i}", HFGuidedCrossAttention(pre, groups))
                feat_ch.append(pre)
                now_res //= 2
        add_rba(pre, pre, True)
        add_rba(pre, pre, False)
        for i, mult in enumerate(reversed(self.channel_mults)):
            ch = inner * mult
            for _ in range(res_blocks + 1):
                add_rba(pre + feat_ch.pop(), ch, now_res in attn_res)
                pre = ch
            if i != n_levels - 1:
                self.add_module(f"Upsample_{i}", Upsample(ch))
                now_res *= 2
        self.final_conv = ConvBlock(pre, out_channels, groups)
        self.eval()
        self.to(dev)

    def compute_static(self, cnn_x: torch.Tensor):
        """Chain-invariant features of the stage-1 estimate ``[B, 1, H, W]``.

        Returns ``((x_lf, x_hf), dwt_queries)`` for the ``static`` argument.
        """
        queries = haar_dwt_highpass_sum(cnn_x, len(self.channel_mults) - 1)
        return self.fd_spliter.static_features(cnn_x), tuple(queries)

    def forward(
        self, x: torch.Tensor, gamma: torch.Tensor, static=None, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        b, _, H, W = x.shape
        if H != self.image_size or W != self.image_size:
            raise ValueError(f"built for {self.image_size}^2 inputs, got {H}x{W}")
        if static is None:
            cnn_x = x[:, 0:1]
            fd_static = None
            dwt_queries = haar_dwt_highpass_sum(cnn_x, len(self.channel_mults) - 1)
        else:
            fd_static, dwt_queries = static

        # The noise-level encoding computes in fp32, then takes the activation dtype.
        emb = self.NoiseLevelMLP_0(gamma).to(x.dtype)
        h = self.conv_in(self.fd_spliter(x, emb, static=fd_static))

        n_rba = 0

        def block(inp):
            nonlocal n_rba
            out = getattr(self, f"ResnetBlockWithAttn_{n_rba}")(inp, emb, generator)
            n_rba += 1
            return out

        n_levels = len(self.channel_mults)
        feats = [h]
        now_res = H
        for i in range(n_levels):
            for _ in range(self.res_blocks):
                h = block(h)
                feats.append(h)
            if i != n_levels - 1:
                h = getattr(self, f"Downsample_{i}")(h)
                now_res //= 2
                # The skip is the CA-modulated map; the trunk continues as h.
                kvp = self.ca_kv_pool if now_res * now_res >= self.ca_kv_pool_min_tokens else 0
                ca = getattr(self, f"HFGuidedCrossAttention_{i}")
                feats.append(ca(h, dwt_queries[i], kv_pool=kvp))

        h = block(h)
        h = block(h)

        for i in range(n_levels):
            for _ in range(self.res_blocks + 1):
                h = block(torch.cat([h, feats.pop()], dim=1))
            if i != n_levels - 1:
                h = getattr(self, f"Upsample_{i}")(h)
        return self.final_conv(h)
