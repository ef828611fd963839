"""Two-stage ResDiff super-resolution pipeline (port of ``mrisr_tpu/pipelines/resdiff.py``).

Stage 1: SimpleCNN predicts the low-frequency estimate from LR.  Stage 2: the
ResDiff UNet denoises the residual ``HR - cnn_sr`` with an SR3
gamma-conditioned DDIM chain; the output is ``cnn_sr + residual``.
Public layout is the reference's: LR in and SR out as ``[B, H, W, 1]``.

On a CUDA pipeline the DDIM chain is one captured ``torch.cuda.CUDAGraph``
per (LR shape, dtype, num_steps, spacing), the counterpart of the
reference's single jitted ``lax.scan`` program: stage 1, ``compute_static``,
every DDIM step and ``cnn_sr + residual``.  The LR and the starting noise
are copied into the graph's static inputs before each replay; the noise is
still drawn from the caller's generator outside the graph, so a graphed and
an eager chain from the same generator give the same result.  A capture or
replay that fails raises.  The kernels' wrappers count the launches they
record while the graph is captured; a replay calls no wrapper and counts
nothing.  ``cuda_graph=False``, and every CPU pipeline, run
the chain eagerly; so does the full-length ancestral chain
(``num_steps=None``), whose per-step noise comes from the generator.

Tracing (``utils/profiling.py``).  The chain's four stages are spans,
``resdiff.stage1``, ``resdiff.static``, ``resdiff.steps`` (every UNet call)
and ``resdiff.combine``: host ranges when eager, and in a captured chain
event pairs that every replay records, read by
``profiling.stage_ms("resdiff.chain")``.  A capture counts
``resdiff.captures`` and ``resdiff.capture_s`` (``profiling.capture``); a
replay is the span ``resdiff.replay`` and counts ``resdiff.replays``.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import torch

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion.schedules import Schedule
from mrisr_torch.models.resdiff_unet import ResDiffUNet
from mrisr_torch.models.simple_cnn import SimpleCNN
from mrisr_torch.pipelines.sampler import sr3_ancestral_sample
from mrisr_torch.utils import profiling


@dataclass
class ChainGraph:
    """A captured chain: its static input buffers, its static output and its stage events.  The graph keeps
    its definition (``keep_graph``), so a caller can read its nodes."""

    graph: torch.cuda.CUDAGraph
    lr: torch.Tensor
    x_T: torch.Tensor
    out: torch.Tensor
    stages: profiling.Stages


class ResDiffPipeline:
    """SimpleCNN + ResDiffUNet + schedule on one device (CUDA by default)."""

    def __init__(
        self,
        cnn: SimpleCNN,
        unet: ResDiffUNet,
        sched: Schedule,
        device: str | torch.device = "cuda",
        cuda_graph: bool = True,
    ):
        self.device = resolve_device(device)
        self.cnn = cnn.to(self.device).eval()
        self.unet = unet.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.graphs: dict[tuple, ChainGraph] = {}

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

    def _start(self, lr: torch.Tensor, generator: torch.Generator | None, x_T: torch.Tensor | None) -> torch.Tensor:
        """The chain's starting noise ``[B, 1, H*s, W*s]`` in LR's dtype: ``x_T`` as given, else drawn
        from ``generator``."""
        b, h, w, _ = lr.shape
        s = self.cnn.scale_factor
        shape = (b, 1, h * s, w * s)
        if x_T is None:
            return torch.randn(shape, generator=generator, device=lr.device, dtype=lr.dtype)
        if tuple(x_T.shape) != (b, h * s, w * s, 1):
            raise ValueError(f"x_T must have shape {(b, h * s, w * s, 1)}, got {tuple(x_T.shape)}")
        return self._nchw(x_T.to(device=lr.device, dtype=lr.dtype))

    def _chain(self, lr, x_T, num_steps, spacing, generator=None) -> torch.Tensor:
        """Stage 1, the chain-invariant features, the chain and ``cnn_sr + residual`` (``[B, H, W, 1]``)."""
        with profiling.span("resdiff.stage1"):
            cnn_sr = self.cnn(self._nchw(lr))  # [B, 1, H, W]
        # Chain-invariant features (FFT split + DWT pyramid), once per chain.
        with profiling.span("resdiff.static"):
            static = self.unet.compute_static(cnn_sr)

        def eps_fn(x_t, gamma):
            return self.unet(torch.cat([cnn_sr, x_t], dim=1), gamma, static=static)

        with profiling.span("resdiff.steps"):
            residual = sr3_ancestral_sample(self.sched, eps_fn, x_T, num_steps, spacing, generator=generator)
        with profiling.span("resdiff.combine"):
            return self._nhwc(cnn_sr + residual)

    def _capture(self, lr: torch.Tensor, x_T: torch.Tensor, num_steps: int, spacing: str) -> ChainGraph:
        """Warm the chain up eagerly once (cuFFT plans, cuDNN algorithms and the kernels' one-time set-up
        must exist before capture), then capture it into a graph with its own memory pool, its stages'
        events with it."""
        with profiling.capture("resdiff", self.device):
            static_lr, static_x = lr.clone(), x_T.clone()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._chain(static_lr, static_x, num_steps, spacing)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            # thread_local: a training loop's data thread may pin host memory meanwhile (validation), which is
            # no work of the capture.
            with profiling.stages("resdiff.chain") as stages, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._chain(static_lr, static_x, num_steps, spacing)
            graph.instantiate()
        return ChainGraph(graph, static_lr, static_x, out, stages)

    def _replay(self, lr: torch.Tensor, x_T: torch.Tensor, num_steps: int, spacing: str) -> torch.Tensor:
        key = (tuple(lr.shape), lr.dtype, num_steps, spacing)
        chain = self.graphs.get(key)
        if chain is None:
            chain = self.graphs[key] = self._capture(lr, x_T, num_steps, spacing)
        chain.lr.copy_(lr)
        chain.x_T.copy_(x_T)
        with profiling.span("resdiff.replay"):
            profiling.replay("resdiff", chain.graph, chain.stages)
        return chain.out.clone()

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
        not given it is drawn from ``generator``.  ``num_steps=None`` runs
        the full-length ancestral chain, whose step noise also comes from
        ``generator``.
        """
        self._check(lr)
        x_T = self._start(lr, generator, x_T)
        if self.cuda_graph and num_steps is not None:
            return self._replay(lr, x_T, num_steps, spacing)
        return self._chain(lr, x_T, num_steps, spacing, generator)

    def super_resolve_rows(
        self,
        lr: torch.Tensor,
        rows: slice,
        generator: torch.Generator | None = None,
        num_steps: int = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """Rows ``rows`` of the result for the batch ``lr``, computed on those rows only: the whole batch's
        starting noise is drawn from ``generator`` and cut, so a data-parallel rank's share equals the
        same rows of the whole batch's chain."""
        if num_steps is None:
            raise ValueError("the ancestral chain draws every step's noise; serve it on the whole batch")
        x_T = self._nhwc(self._start(lr, generator, None))
        return self.super_resolve(lr[rows], x_T=x_T[rows], num_steps=num_steps, spacing=spacing)

    def super_resolve_many(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | Sequence[torch.Generator] | None = None,
        num_steps: int | None = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """G chains back to back: ``[G, B, H, W, 1]`` in and out.

        ``generator`` is one generator that every chain draws from in turn,
        or one generator per chain.
        """
        if lr_stack.ndim != 5:
            raise ValueError(f"lr_stack must be [G, B, H, W, 1], got {tuple(lr_stack.shape)}")
        gens = generator if isinstance(generator, Sequence) else [generator] * lr_stack.shape[0]
        if len(gens) != lr_stack.shape[0]:
            raise ValueError(f"{len(gens)} generators for {lr_stack.shape[0]} chains")
        return torch.stack([self.super_resolve(lr, g, None, num_steps, spacing) for lr, g in zip(lr_stack, gens)])

    def super_resolve_group(
        self,
        lr_stack: torch.Tensor,
        generator: torch.Generator | Sequence[torch.Generator] | None = None,
        num_steps: int | None = 50,
        spacing: str = "trailing",
    ) -> torch.Tensor:
        """Grouped-dispatch entry point, the same call on every pipeline family."""
        return self.super_resolve_many(lr_stack, generator, num_steps, spacing)
