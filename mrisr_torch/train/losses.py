"""Loss functions on NCHW images (port of ``mrisr_tpu/train/losses.py``)."""
from __future__ import annotations

import torch


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def frequency_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean |FFT2 difference| over the spatial dims (H, W) of NCHW images."""
    pf = torch.fft.fft2(pred.float(), dim=(-2, -1))
    tf = torch.fft.fft2(target.float(), dim=(-2, -1))
    return torch.mean(torch.abs(pf - tf))


def image_compare_loss(pred: torch.Tensor, target: torch.Tensor, freq_weight: float = 0.1) -> torch.Tensor:
    """Pixel MSE + ``freq_weight`` x frequency L1 normalised by H*W."""
    n = pred.shape[-2] * pred.shape[-1]
    return l2(pred, target) + freq_weight * frequency_l1(pred, target) / n
