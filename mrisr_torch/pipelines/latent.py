"""Latent SR pipeline: SD1.5 UNet + ControlNet (or T2I-Adapter) + VAE with Res-SRDiff shifting.

Port of ``mrisr_tpu/pipelines/latent.py`` (the reference's PEFT inference
path): VAE-encode the LR slice (times the scaling factor) as the shifting
anchor; start at the shifted state ``x_T ~ LR + noise``; each step runs the
ControlNet (condition embedding computed once a chain) and the UNet, or the
UNet with the adapter's features (computed once a chain), then the manual
Res-SRDiff reverse step re-anchored on the LR latents; VAE-decode.  The text
condition is a fixed prompt embedding.  LoRA weights are merged into the
UNet beforehand (``models/lora.py::merge_lora``).  Public layout is the
reference's: LR ``[B, H, W, 1]`` in, ``[B, H, W, 3]`` in [-1, 1] out.

On a CUDA pipeline the chain is one captured ``torch.cuda.CUDAGraph`` per
(LR shape, dtype, steps): VAE encode, the condition embedding or adapter
features, every step and the decode.  All of its random draws (the VAE
posterior noise, the starting noise and the ``[steps, B, 4, h, w]`` step
noises) are made outside the graph from the caller's generator into static
buffers, so a graphed and an eager chain from the same generator agree
bitwise.  ``cuda_graph=False``, and every CPU pipeline, run the chain
eagerly.  The two encoder towers run one after the other (the reference's
stacked-weight form, ``models/fused.py``, is not ported).

Dtypes follow the reference's promotion: the VAE encoder, the condition
embedding or adapter features and the prompt's projections run in their
inputs' dtype (bf16 in a bf16 chain); the shifted start state is float32
(the schedule's dtype), so every carry after it, the UNet and ControlNet
steps and the VAE decoder compute in float32 against the modules' weights
(bf16-rounded in a bf16 chain, upcast exactly).  The output is float32.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion.schedules import Schedule
from mrisr_torch.models.adapter import T2IAdapter
from mrisr_torch.models.controlnet import ControlNet, embed_condition
from mrisr_torch.models.sd_unet import SDUNet
from mrisr_torch.models.vae import AutoencoderKL
from mrisr_torch.pipelines.sampler import res_shift_sample


def prepare_condition_image(image: torch.Tensor, target_hw: tuple[int, int] = (512, 512)) -> torch.Tensor:
    """``[B, H, W, C]``: one channel repeated to three, then a bilinear resize (``align_corners=False``)
    only where the size differs."""
    if image.shape[-1] == 1:
        image = image.expand(*image.shape[:-1], 3)
    if tuple(image.shape[1:3]) != tuple(target_hw):
        nchw = F.interpolate(image.permute(0, 3, 1, 2), size=tuple(target_hw), mode="bilinear", align_corners=False)
        image = nchw.permute(0, 2, 3, 1)
    return image


@dataclass
class ChainNoise:
    """A chain's random draws, float32: the VAE posterior noise and the starting noise ``[B, 4, h, w]``,
    and the step noises ``[steps, B, 4, h, w]``."""

    vae: torch.Tensor
    start: torch.Tensor
    steps: torch.Tensor

    @classmethod
    def draw(cls, shape, steps: int, generator: torch.Generator | None, device) -> "ChainNoise":
        """Drawn from ``generator`` in this order: posterior, start, then each step's."""
        def randn(s):
            return torch.randn(s, generator=generator, device=device, dtype=torch.float32)

        return cls(randn(shape), randn(shape), randn((steps, *shape)))


@dataclass
class LatentChainGraph:
    """A captured chain: its static inputs, its static output, and the graph (kept, so a caller can read
    its nodes)."""

    graph: torch.cuda.CUDAGraph
    lr: torch.Tensor
    noise: ChainNoise
    out: torch.Tensor


class LatentSRPipeline:
    """SDUNet + ControlNet (or T2I-Adapter) + AutoencoderKL + schedule on one device (CUDA by default).

    ``adapter`` selects the T2I-Adapter mode; ``controlnet`` is then unused
    and may be None.
    """

    def __init__(
        self,
        unet: SDUNet,
        controlnet: ControlNet | None,
        vae: AutoencoderKL,
        sched: Schedule,
        prompt_embeds: torch.Tensor,
        prediction_type: str = "epsilon",
        adapter: T2IAdapter | None = None,
        device: str | torch.device = "cuda",
        cuda_graph: bool = True,
    ):
        if adapter is None and controlnet is None:
            raise ValueError("a ControlNet or a T2I-Adapter is needed")
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.adapter = None if adapter is None else adapter.to(self.device).eval()
        self.controlnet = None if self.adapter is not None else controlnet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.prompt_embeds = prompt_embeds.to(self.device)
        self.prediction_type = prediction_type
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.graphs: dict[tuple, LatentChainGraph] = {}

    @property
    def mode(self) -> str:
        return "controlnet" if self.adapter is None else "adapter"

    def _check(self, lr: torch.Tensor) -> None:
        if lr.ndim != 4 or lr.shape[-1] != 1:
            raise ValueError(f"LR must be [B, H, W, 1], got {tuple(lr.shape)}")
        if lr.device != self.device:
            raise ValueError(f"LR is on {lr.device}, the pipeline on {self.device}")
        f = self.vae.downsample_factor
        if lr.shape[1] % f or lr.shape[2] % f:
            raise ValueError(f"LR height and width must be multiples of the VAE's factor {f}, "
                             f"got {tuple(lr.shape[1:3])}")

    def latent_shape(self, lr: torch.Tensor) -> tuple[int, ...]:
        """The VAE's latents of ``lr`` (8x smaller for SD1.5's VAE, 4x for a three-stage one)."""
        b, h, w, _ = lr.shape
        f = self.vae.downsample_factor
        return (b, self.unet.conv_in.in_channels, h // f, w // f)

    def _chain(self, lr: torch.Tensor, noise: ChainNoise, num_steps: int) -> torch.Tensor:
        """The whole chain on ``[B, H, W, 1]`` LR -> ``[B, H, W, 3]``."""
        b, h, w, _ = lr.shape
        cond = prepare_condition_image(lr, (h, w)).permute(0, 3, 1, 2).contiguous()  # [B, 3, H, W]
        sf = self.vae.scaling_factor
        anchor = self.vae.encode(cond, noise.vae) * sf
        ctx = self.prompt_embeds[:1].expand(b, *self.prompt_embeds.shape[1:])
        if self.adapter is not None:
            feats = self.adapter(cond)

            def eps_fn(x_t, t):
                return self.unet(x_t, t, ctx, adapter_features=feats)
        else:
            cond_emb = embed_condition(self.controlnet, cond)

            def eps_fn(x_t, t):
                down, mid = self.controlnet(x_t, t, ctx, cond_embedding=cond_emb)
                return self.unet(x_t, t, ctx, down_block_additional_residuals=down,
                                 mid_block_additional_residual=mid)

        latents = res_shift_sample(self.sched, eps_fn, anchor, noise.start, noise.steps, num_steps,
                                   prediction_type=self.prediction_type)
        return self.vae.decode(latents / sf).permute(0, 2, 3, 1).contiguous()

    def _capture(self, lr: torch.Tensor, noise: ChainNoise, num_steps: int) -> LatentChainGraph:
        """Warm the chain up eagerly on a side stream (cuDNN algorithms and the kernels' one-time set-up
        must exist before capture), then capture it into a graph with its own memory pool."""
        static_lr = lr.clone()
        static_noise = ChainNoise(noise.vae.clone(), noise.start.clone(), noise.steps.clone())
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._chain(static_lr, static_noise, num_steps)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = self._chain(static_lr, static_noise, num_steps)
        graph.instantiate()
        return LatentChainGraph(graph, static_lr, static_noise, out)

    def _replay(self, lr: torch.Tensor, noise: ChainNoise, num_steps: int) -> torch.Tensor:
        key = (tuple(lr.shape), lr.dtype, num_steps, self.mode)
        chain = self.graphs.get(key)
        if chain is None:
            chain = self.graphs[key] = self._capture(lr, noise, num_steps)
        chain.lr.copy_(lr)
        for name in ("vae", "start", "steps"):
            getattr(chain.noise, name).copy_(getattr(noise, name))
        chain.graph.replay()
        return chain.out.clone()

    @torch.no_grad()
    def super_resolve(
        self,
        lr: torch.Tensor,
        generator: torch.Generator | None = None,
        num_steps: int = 20,
        noise: ChainNoise | None = None,
    ) -> torch.Tensor:
        """LR ``[B, H, W, 1]`` in [-1, 1] -> ``[B, H, W, 3]`` in [-1, 1].

        ``noise`` holds the chain's draws; when it is not given they are
        drawn from ``generator`` (:meth:`ChainNoise.draw`).
        """
        self._check(lr)
        shape = self.latent_shape(lr)
        if noise is None:
            noise = ChainNoise.draw(shape, num_steps, generator, lr.device)
        elif (tuple(noise.vae.shape), tuple(noise.start.shape), tuple(noise.steps.shape)) != (
                shape, shape, (num_steps, *shape)):
            raise ValueError(f"noise does not fit latents {shape} and {num_steps} steps")
        if self.cuda_graph:
            return self._replay(lr, noise, num_steps)
        return self._chain(lr, noise, num_steps)

    def super_resolve_many(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | Sequence[torch.Generator] | None = None,
        num_steps: int = 20,
    ) -> torch.Tensor:
        """G chains back to back: ``[G, B, H, W, 1]`` in, ``[G, B, H, W, 3]`` out.  ``generator`` is one
        generator every chain draws from in turn, or one per chain."""
        if lr_stack.ndim != 5:
            raise ValueError(f"lr_stack must be [G, B, H, W, 1], got {tuple(lr_stack.shape)}")
        gens = generator if isinstance(generator, Sequence) else [generator] * lr_stack.shape[0]
        if len(gens) != lr_stack.shape[0]:
            raise ValueError(f"{len(gens)} generators for {lr_stack.shape[0]} chains")
        return torch.stack([self.super_resolve(lr, g, num_steps) for lr, g in zip(lr_stack, gens)])

    def super_resolve_group(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | Sequence[torch.Generator] | None = None,
        num_steps: int = 20,
    ) -> torch.Tensor:
        """Grouped-dispatch entry point, the same call on every pipeline family."""
        return self.super_resolve_many(lr_stack, generator, num_steps)


def decode_to_vis(img: torch.Tensor) -> np.ndarray:
    """The first image of ``[B, H, W, C]`` in [-1, 1] -> uint8 ``[H, W, 3]``."""
    arr = (img[0].float().cpu() / 2 + 0.5).clamp(0, 1).numpy()
    arr = (arr * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr
