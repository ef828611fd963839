"""Two-stage ResDiff super-resolution pipeline (port of ``mrisr_tpu/pipelines/resdiff.py``).

Stage 1: SimpleCNN predicts the low-frequency estimate from LR.  Stage 2: the
ResDiff UNet denoises the residual ``HR - cnn_sr`` with an SR3
gamma-conditioned DDIM chain; the output is ``cnn_sr + residual``.
Public layout is the reference's: LR in and SR out as ``[B, H, W, 1]``.
"""
from __future__ import annotations

import torch

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion.schedules import Schedule
from mrisr_torch.models.resdiff_unet import ResDiffUNet
from mrisr_torch.models.simple_cnn import SimpleCNN
from mrisr_torch.pipelines.sampler import sr3_ancestral_sample


class ResDiffPipeline:
    """SimpleCNN + ResDiffUNet + schedule on one device (CUDA by default)."""

    def __init__(
        self,
        cnn: SimpleCNN,
        unet: ResDiffUNet,
        sched: Schedule,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cnn = cnn.to(self.device).eval()
        self.unet = unet.to(self.device).eval()
        self.sched = sched.to(self.device)

    def _check(self, lr: torch.Tensor) -> None:
        if lr.ndim != 4 or lr.shape[-1] != 1:
            raise ValueError(f"LR must be [B, H, W, 1], got {tuple(lr.shape)}")
        if lr.device != self.device:
            raise ValueError(f"LR is on {lr.device}, the pipeline on {self.device}")

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 1]`` -> ``[B, 1, H, W]``; with one channel both are one reshape.

        (A permute would leave channels-last strides, which the
        convolutions would carry on to the NCHW kernels.)
        """
        b, h, w, _ = x.shape
        return x.reshape(b, 1, h, w)

    @staticmethod
    def _nhwc(x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        return x.reshape(b, h, w, 1)

    @torch.no_grad()
    def stage1(self, lr: torch.Tensor) -> torch.Tensor:
        self._check(lr)
        return self._nhwc(self.cnn(self._nchw(lr)))

    @torch.no_grad()
    def super_resolve(
        self,
        lr: torch.Tensor,
        generator: torch.Generator | None = None,
        x_T: torch.Tensor | None = None,
        num_steps: int | None = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """LR ``[B, H, W, 1]`` -> SR ``[B, H, W, 1]``.

        ``x_T`` (``[B, H, W, 1]``) is the chain's starting noise; when it is
        not given it is drawn from ``generator``.
        """
        self._check(lr)
        cnn_sr = self.cnn(self._nchw(lr))  # [B, 1, H, W]
        # Chain-invariant features (FFT split + DWT pyramid), once per chain.
        static = self.unet.compute_static(cnn_sr)
        if x_T is None:
            x_T = torch.randn(cnn_sr.shape, generator=generator, device=cnn_sr.device, dtype=cnn_sr.dtype)
        else:
            if tuple(x_T.shape) != tuple(lr.shape):
                raise ValueError(f"x_T must have shape {tuple(lr.shape)}, got {tuple(x_T.shape)}")
            x_T = self._nchw(x_T.to(device=cnn_sr.device, dtype=cnn_sr.dtype))

        def eps_fn(x_t, gamma):
            return self.unet(torch.cat([cnn_sr, x_t], dim=1), gamma, static=static)

        residual = sr3_ancestral_sample(self.sched, eps_fn, x_T, num_steps, spacing)
        return self._nhwc(cnn_sr + residual)

    def super_resolve_many(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | None = None,
        num_steps: int | None = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """G chains back to back: ``[G, B, H, W, 1]`` in and out."""
        if lr_stack.ndim != 5:
            raise ValueError(f"lr_stack must be [G, B, H, W, 1], got {tuple(lr_stack.shape)}")
        return torch.stack(
            [self.super_resolve(lr, generator, None, num_steps, spacing) for lr in lr_stack]
        )

    def super_resolve_group(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | None = None,
        num_steps: int | None = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """Grouped-dispatch entry point, the same call on every pipeline family."""
        return self.super_resolve_many(lr_stack, generator, num_steps, spacing)
