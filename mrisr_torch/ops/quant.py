"""Dynamic int8 convolution, the int8 serving profile (port of ``mrisr_tpu/ops/quant.py``), NCHW / OIHW.

A conv's operands are quantized when it runs: the activation with one
symmetric scale for the tensor, the weight with one symmetric scale per
output channel (``max|.| / 127``, rounded half to even).  The convolution
runs on the int8 values with int32 accumulation, and the result is
dequantized in float32 (``out * (sx * sw) + bias``) and cast to the
activation's dtype.  No parameter changes, so one checkpoint serves the exact
and the int8 profiles.

The reference computes the integer convolution with XLA's conv outside any
Pallas kernel.  Here a CUDA tensor takes the tensor cores' int8 product
(``torch._int_mm``, int32 accumulation) over the unfolded activation; its
shape rules (rows > 16, inner and output sizes multiples of 8) hold at every
ResDiff conv, and a shape that breaks them raises.  A CPU tensor takes the
plain version: a float64 convolution of the integer values, exact because
every partial sum stays below 2^53, cast to int32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127``, correctly rounded on every device: CUDA divides by a Python number (a CPU scalar) as a
    multiplication by its rounded reciprocal, which can move a scale by one ulp and a value across a rounding
    boundary."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``x ≈ q * scale`` (``scale`` a float32 scalar)."""
    xf = x.float()
    scale = _over_127(xf.abs().max().clamp_min(1e-8))
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_per_out_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of an OIHW weight, one scale per output channel (dim 0): ``[O]``."""
    wf = w.float()
    scale = _over_127(wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8))
    return torch.round(wf / scale[:, None, None, None]).to(torch.int8), scale


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after), the odd element after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: tuple[int, int],
                    pads: tuple[int, int, int, int]) -> torch.Tensor:
    """The integer convolution on the CPU: int8 NCHW ``xq`` and OIHW ``wq`` -> int32, exact."""
    x = F.pad(xq.double(), pads)
    return F.conv2d(x, wq.double(), stride=stride).round().to(torch.int32)


def _int8_conv_cuda(xq: torch.Tensor, wq: torch.Tensor, stride: tuple[int, int],
                    pads: tuple[int, int, int, int]) -> torch.Tensor:
    """The integer convolution on the tensor cores: the unfolded activation ``[B*Ho*Wo, I*kh*kw]`` times the
    weight ``[I*kh*kw, O]`` (``torch._int_mm``, int32 accumulation) -> int32 NCHW."""
    o, i, kh, kw = wq.shape
    x = F.pad(xq, pads)
    cols = x.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])  # [B, I, Ho, Wo, kh, kw], a view
    b, _, ho, wo = cols.shape[:4]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, i * kh * kw)
    m, k = a.shape
    if m <= 16 or k % 8 or o % 8:
        raise ValueError(f"int8_conv on CUDA needs B*Ho*Wo > 16 and I*kh*kw, O multiples of 8 (torch._int_mm); "
                         f"got {m}, {k}, {o}")
    out = torch._int_mm(a, wq.reshape(o, k).t())  # [M, O] int32
    return out.view(b, ho, wo, o).permute(0, 3, 1, 2).contiguous()


def int8_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
              stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """``"SAME"``-padded conv of NCHW ``x`` (any float dtype) with OIHW ``w``, computed in int8 with int32
    accumulation; the dequantized result in ``x.dtype``."""
    xq, sx = quantize_per_tensor(x)
    wq, sw = quantize_per_out_channel(w)
    (pt, pb), (pl, pr) = (same_padding(x.shape[d + 2], w.shape[d + 2], stride[d]) for d in (0, 1))
    pads = (pl, pr, pt, pb)
    out = _int8_conv_cuda(xq, wq, stride, pads) if x.is_cuda else int8_conv_plain(xq, wq, stride, pads)
    out = out.float() * (sx * sw)[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(x.dtype)
