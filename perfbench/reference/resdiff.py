"""Plain PyTorch reference of the ResDiff serving chain, frozen with the benchmark.

Stage 1 (``SimpleCNN`` at scale 1), the chain-invariant features (the FFT
split and the Haar DWT pyramid), the ResDiff UNet (SR3 backbone, the
frequency-domain splitter, DWT-guided cross-attention at the skips), the
1000-step linear ResDiff schedule and the trailing-spaced DDIM chain with eta
0, written out in float32 with nothing but ``torch`` operations: no kernel,
no cache, no graph.  It follows the Bernat-C/MRI-Diffusion-SuperResolution
``ResDif_execution.ipynb`` model as the port states it; the parameter names
are the port's, so one set of weights made by the benchmark fills both.

Attention is computed exactly, in blocks of ``QUERY_BLOCK`` queries so that
the 16384-key sites fit.  GroupNorm followed by SiLU is ``F.group_norm`` and
``F.silu``.  A ``Work`` recorder handed to :meth:`ResDiffUNet.forward` notes
each attention site and each GroupNorm+SiLU head, which the benchmark's
roofline readers take as the work of the chain.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-5
QUERY_BLOCK = 2048


@dataclass
class Work:
    """Sites noted during one forward: ``attention`` ``(b, n, m, d)`` and ``gn_silu`` ``(shape, groups)``."""

    attention: list = field(default_factory=list)
    gn_silu: list = field(default_factory=list)


def attention(q, k, v, scale, work=None):
    """Exact ``softmax(scale q k^T) v`` on ``[B, N, D]`` / ``[B, M, D]``, in query blocks."""
    if work is not None:
        work.attention.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
    out = []
    for i in range(0, q.shape[1], QUERY_BLOCK):
        s = torch.einsum("bnd,bmd->bnm", q[:, i:i + QUERY_BLOCK], k) * scale
        out.append(torch.einsum("bnm,bmd->bnd", torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=1)


def gn_silu(x, norm, work=None):
    if work is not None:
        work.gn_silu.append((tuple(x.shape), norm.num_groups))
    return F.silu(F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps))


def tokens(x):
    """``[B, C, H, W]`` -> ``[B, H*W, C]``."""
    return x.flatten(2).transpose(1, 2)


def from_tokens(t, h, w):
    b, _, c = t.shape
    return t.transpose(1, 2).reshape(b, c, h, w)


class SimpleCNN(nn.Module):
    """conv(1->64) ReLU, conv(64->32) ReLU, conv(32->1), plus the input (scale 1)."""

    def __init__(self, hidden=64):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, hidden // 2, 3, padding=1)
        self.Conv_2 = nn.Conv2d(hidden // 2, 1, 3, padding=1)

    def forward(self, x):
        return self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x))))) + x


class NoiseLevelMLP(nn.Module):
    """SR3 noise-level encoding (sin | cos of gamma times 1e4^-(i/count)), Dense(4d), swish, Dense(d)."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.Dense_0 = nn.Linear(dim, dim * 4)
        self.Dense_1 = nn.Linear(dim * 4, dim)

    def forward(self, gamma):
        count = self.dim // 2
        freqs = torch.exp(-math.log(1e4) * torch.arange(count, dtype=torch.float32, device=gamma.device) / count)
        args = gamma.reshape(-1, 1) * freqs[None, :]
        return self.Dense_1(F.silu(self.Dense_0(torch.cat([torch.sin(args), torch.cos(args)], dim=-1))))


class SEBlock(nn.Module):
    """``x * sigmoid(fc(relu(fc(mean_hw(x))))) + x``."""

    def __init__(self, channels, reduction=2):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.Dense_0 = nn.Linear(channels, hidden, bias=False)
        self.Dense_1 = nn.Linear(hidden, channels, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None] + x


def dropout(x, rate, generator):
    """Each element kept where a uniform draw from ``generator`` is ``>= rate``, the kept scaled by 1/(1 - rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class ConvBlock(nn.Module):
    """GroupNorm, SiLU, (dropout while training), 3x3 conv."""

    def __init__(self, cin, cout, groups, rate=0.0):
        super().__init__()
        self.rate = rate
        self.GroupNorm_0 = nn.GroupNorm(groups, cin, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x, work=None, generator=None):
        h = gn_silu(x, self.GroupNorm_0, work)
        if generator is not None and self.rate > 0.0:
            h = dropout(h, self.rate, generator)
        return self.Conv_0(h)


class ResnetBlock(nn.Module):
    """Two ConvBlocks (dropout in the second) with the noise embedding added between them, and the shortcut."""

    def __init__(self, cin, cout, groups, emb_dim, rate=0.0):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, cout, groups)
        self.Dense_0 = nn.Linear(emb_dim, cout)
        self.ConvBlock_1 = ConvBlock(cout, cout, groups, rate)
        if cin != cout:
            self.Conv_0 = nn.Conv2d(cin, cout, 1)

    def forward(self, x, emb, work=None, generator=None):
        h = self.ConvBlock_0(x, work) + self.Dense_0(emb)[:, :, None, None]
        h = self.ConvBlock_1(h, work, generator)
        return h + (self.Conv_0(x) if hasattr(self, "Conv_0") else x)


class SelfAttention2D(nn.Module):
    """One-head spatial self-attention over H*W with 1/sqrt(C) scaling, output projection, residual."""

    def __init__(self, channels, groups):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(channels, channels * 3, 1, bias=False)
        self.Conv_1 = nn.Conv2d(channels, channels, 1)

    def forward(self, x, work=None):
        _, c, h, w = x.shape
        q, k, v = tokens(self.Conv_0(self.GroupNorm_0(x))).chunk(3, dim=-1)
        return self.Conv_1(from_tokens(attention(q, k, v, 1.0 / math.sqrt(c), work), h, w)) + x


class ResnetBlockWithAttn(nn.Module):
    def __init__(self, cin, cout, groups, emb_dim, with_attn, rate=0.0):
        super().__init__()
        self.ResnetBlock_0 = ResnetBlock(cin, cout, groups, emb_dim, rate)
        if with_attn:
            self.SelfAttention2D_0 = SelfAttention2D(cout, groups)

    def forward(self, x, emb, work=None, generator=None):
        x = self.ResnetBlock_0(x, emb, work, generator)
        return self.SelfAttention2D_0(x, work) if hasattr(self, "SelfAttention2D_0") else x


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.Conv_0(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels):
        super().__init__()
        self.Conv_0 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))


class HFGuidedCrossAttention(nn.Module):
    """Queries from the DWT band-pass map (1x1 conv to C), keys and values from the GroupNorm'd map (1x1
    conv), one head at 1/sqrt(C), output projection, residual.  ``kv_pool`` > 1: K/V from the
    ``kv_pool``-average-pooled normalised map."""

    def __init__(self, channels, groups):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(groups, channels, eps=GN_EPS)
        self.Conv_0 = nn.Conv2d(channels, channels * 2, 1, bias=False)
        self.Conv_1 = nn.Conv2d(1, channels, 1, bias=False)
        self.Conv_2 = nn.Conv2d(channels, channels, 1)

    def forward(self, x, query_map, kv_pool=0, work=None):
        _, c, h, w = x.shape
        n = self.GroupNorm_0(x)
        if kv_pool > 1:
            n = F.avg_pool2d(n, kv_pool, kv_pool)
        k, v = tokens(self.Conv_0(n)).chunk(2, dim=-1)
        q = tokens(self.Conv_1(query_map))
        return self.Conv_2(from_tokens(attention(q, k, v, 1.0 / math.sqrt(c), work), h, w)) + x


def haar_highpass_pyramid(x, levels):
    """At each of ``levels`` Haar levels (pywt's convention), LH + HL + HH; the next level takes LL."""
    out = []
    for _ in range(levels):
        a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
        c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
        out.append(((a - b + c - d) + (a + b - c - d) + (a - b - c + d)) * 0.5)
        x = (a + b + c + d) * 0.5
    return out


def gaussian_highpass(x, sigma):
    """The FFT of ``x`` [B, 1, H, W] times 1 - exp(-D^2 / 2 sigma^2), D the distance from the centre of the
    (unshifted) grid; returns (filtered FFT, |inverse FFT|)."""
    n, m = x.shape[-2:]
    u = torch.arange(n, dtype=torch.float32, device=x.device) - n / 2.0
    v = torch.arange(m, dtype=torch.float32, device=x.device) - m / 2.0
    d2 = u[:, None] ** 2 + v[None, :] ** 2
    xf = torch.fft.fft2(x) * (1.0 - torch.exp(-d2 / (2.0 * sigma.reshape(-1, 1, 1, 1) ** 2)))
    return xf, torch.fft.ifft2(xf).abs()


class FDInfoSpliter(nn.Module):
    def __init__(self, emb_dim, image_size):
        super().__init__()
        self.image_size = image_size
        self.noise_func = nn.Linear(emb_dim, image_size)
        self.noise_resSE = SEBlock(1)
        self.sigma_resSE = SEBlock(2)
        self.HF_guided_resSE = SEBlock(2)
        self.channel_transform = nn.Conv2d(2, 1, 1)

    def static_features(self, cnn_x):
        """(x_lf, x_hf) of the stage-1 estimate: a learned sigma from the FFT, the Gaussian high-pass split."""
        xf = torch.fft.fft2(cnn_x[:, 0])
        pooled = self.sigma_resSE(torch.stack([xf.real, xf.imag], dim=1)).mean(dim=(2, 3))
        sigma = (pooled.mean(dim=-1).abs() + self.image_size / 2.0).clamp(max=float(self.image_size - 10))
        xf_f, hf = gaussian_highpass(cnn_x, sigma)
        atten = self.channel_transform(self.HF_guided_resSE(torch.stack([xf_f[:, 0].real, xf_f[:, 0].imag], dim=1)))
        return cnn_x * atten, hf

    def forward(self, x, emb, static):
        cnn_x, xt = x[:, 0:1], x[:, 1:2]
        b, _, h, _ = x.shape
        noise_img = self.noise_func(emb)[:, None, None, :].expand(b, 1, h, self.image_size)
        x_lf, x_hf = static
        return torch.cat([xt, cnn_x, xt * self.noise_resSE(noise_img), x_lf, x_hf], dim=1)


class ResDiffUNet(nn.Module):
    def __init__(self, image_size=256, inner_channel=32, channel_mults=(1, 2, 4, 4), res_blocks=1,
                 attn_res=(8,), norm_groups=16, ca_kv_pool=0, ca_kv_pool_min_tokens=4096, dropout=0.0):
        super().__init__()
        self.image_size = image_size
        self.channel_mults = tuple(channel_mults)
        self.res_blocks = res_blocks
        self.ca_kv_pool, self.ca_kv_pool_min_tokens = ca_kv_pool, ca_kv_pool_min_tokens
        inner, groups, levels = inner_channel, norm_groups, len(self.channel_mults)
        self.NoiseLevelMLP_0 = NoiseLevelMLP(inner)
        self.fd_spliter = FDInfoSpliter(inner, image_size)
        self.conv_in = nn.Conv2d(5, inner, 3, padding=1)
        blocks = []

        def add(cin, cout, attn):
            self.add_module(f"ResnetBlockWithAttn_{len(blocks)}",
                            ResnetBlockWithAttn(cin, cout, groups, inner, attn, dropout))
            blocks.append(None)

        pre, res, feat_ch = inner, image_size, [inner]
        for i, mult in enumerate(self.channel_mults):
            for _ in range(res_blocks):
                add(pre, inner * mult, res in attn_res)
                pre = inner * mult
                feat_ch.append(pre)
            if i != levels - 1:
                self.add_module(f"Downsample_{i}", Downsample(pre))
                self.add_module(f"HFGuidedCrossAttention_{i}", HFGuidedCrossAttention(pre, groups))
                feat_ch.append(pre)
                res //= 2
        add(pre, pre, True)
        add(pre, pre, False)
        for i, mult in enumerate(reversed(self.channel_mults)):
            for _ in range(res_blocks + 1):
                add(pre + feat_ch.pop(), inner * mult, res in attn_res)
                pre = inner * mult
            if i != levels - 1:
                self.add_module(f"Upsample_{i}", Upsample(pre))
                res *= 2
        self.final_conv = ConvBlock(pre, 1, groups)
        self.n_blocks = len(blocks)

    def static(self, cnn_x):
        return self.fd_spliter.static_features(cnn_x), haar_highpass_pyramid(cnn_x, len(self.channel_mults) - 1)

    def forward(self, x, gamma, static=None, work=None, generator=None):
        """eps ``[B, 1, H, W]`` of ``x`` = cat(stage-1 estimate, x_t); ``static`` the estimate's features
        (computed here when not given); ``generator`` draws the dropout masks (a training forward), in the order
        the blocks run."""
        fd_static, queries = self.static(x[:, 0:1]) if static is None else static
        emb = self.NoiseLevelMLP_0(gamma)
        h = self.conv_in(self.fd_spliter(x, emb, fd_static))
        blocks = iter(getattr(self, f"ResnetBlockWithAttn_{i}") for i in range(self.n_blocks))
        levels = len(self.channel_mults)
        feats, res = [h], x.shape[-1]
        for i in range(levels):
            for _ in range(self.res_blocks):
                h = next(blocks)(h, emb, work, generator)
                feats.append(h)
            if i != levels - 1:
                h = getattr(self, f"Downsample_{i}")(h)
                res //= 2
                pool = self.ca_kv_pool if res * res >= self.ca_kv_pool_min_tokens else 0
                feats.append(getattr(self, f"HFGuidedCrossAttention_{i}")(h, queries[i], pool, work))
        h = next(blocks)(h, emb, work, generator)
        h = next(blocks)(h, emb, work, generator)
        for i in range(levels):
            for _ in range(self.res_blocks + 1):
                h = next(blocks)(torch.cat([h, feats.pop()], dim=1), emb, work, generator)
            if i != levels - 1:
                h = getattr(self, f"Upsample_{i}")(h)
        return self.final_conv(h, work)


def resdiff_alphas_cumprod(timesteps=1000):
    """The linear 1e-6 -> 1e-2 beta ramp's cumulative product of alphas, in float64."""
    return np.cumprod(1.0 - np.linspace(1e-6, 1e-2, timesteps, dtype=np.float64))


def trailing_timesteps(timesteps, steps):
    return np.round(np.arange(timesteps, 0, -timesteps / steps)).astype(np.int64) - 1


def chain(cnn, unet, lr, x_T, steps, timesteps=1000, work=None):
    """The served chain on NCHW ``lr`` and ``x_T`` ``[B, 1, H, W]``: ``(sr, cnn_sr)``, both ``[B, 1, H, W]``.

    SR3 conditioning (gamma = sqrt(alpha_bar_t)), DDIM with eta 0 from each trailing-spaced t to the next
    (the last to x0), x0 clipped to [-1, 1] and eps recomputed from it.  ``work`` notes the sites of the
    first UNet call only.
    """
    ac64 = resdiff_alphas_cumprod(timesteps)
    ac = torch.as_tensor(ac64, dtype=torch.float32, device=lr.device)
    sqrt_ac = torch.as_tensor(np.sqrt(ac64), dtype=torch.float32, device=lr.device)
    sqrt_1m = torch.as_tensor(np.sqrt(1.0 - ac64), dtype=torch.float32, device=lr.device)
    cnn_sr = cnn(lr)
    static = unet.static(cnn_sr)
    ts = [int(t) for t in trailing_timesteps(timesteps, steps)]
    x, b = x_T, lr.shape[0]
    for i, (t, tp) in enumerate(zip(ts, ts[1:] + [-1])):
        eps = unet(torch.cat([cnn_sr, x], dim=1), sqrt_ac[t].expand(b), static, work if i == 0 else None)
        x0 = ((x - sqrt_1m[t] * eps) / sqrt_ac[t]).clamp(-1.0, 1.0)
        eps = (x - ac[t].sqrt() * x0) / (1.0 - ac[t]).sqrt()
        ac_prev = ac[tp] if tp >= 0 else torch.ones((), device=lr.device)
        x = ac_prev.sqrt() * x0 + (1.0 - ac_prev).clamp(min=0.0).sqrt() * eps
    return cnn_sr + x, cnn_sr
