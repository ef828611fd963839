"""Serving throughput of the port in slices per second per GPU: the ResDiff chain, or the latent SD1.5 chain.

Run from the repository root on a machine with a CUDA card::

    python3 -m mrisr_torch.bench                 # fast profile (--fast 8), 8 chains a call, CUDA graph
    python3 -m mrisr_torch.bench --fast 0        # exact profile
    python3 -m mrisr_torch.bench --no-graph      # the same chains run eagerly, for the A/B
    python3 -m mrisr_torch.bench --pipeline latent            # ControlNet mode, CUDA graph
    python3 -m mrisr_torch.bench --pipeline latent --adapter  # T2I-Adapter mode
    python3 -m mrisr_torch.bench --int8          # the int8 profile (ResDiff)
    python3 -m mrisr_torch.bench --pipeline latent --no-fused  # towers one after the other (--fused: forced on)
    python3 -m mrisr_torch.bench --pipeline latent --no-fused --no-precompute-cond  # condition embedded each step

The ResDiff workload is the one ``bench.py`` times for the JAX package:
SimpleCNN + ResDiffUNet at full width with random weights from fixed seeds,
cast to ``--dtype``, ``--chains`` G chains of ``--batch`` slices a call
through ``ResDiffPipeline.super_resolve_many`` (50-step DDIM at 256^2, 8
chains a call by default).  The latent workload is ``bench.py``'s
``bench_latent``: ``SDUNet()``, ``ControlNet()`` (or ``T2IAdapter()``) and
``AutoencoderKL()`` at SD1.5's widths with random weights from ``--seed``, a
77x768 prompt context, a 512^2 condition (64^2 latents), bs 8, 20
Res-SRDiff steps, one chain a call through
``LatentSRPipeline.super_resolve_many``.  One warm-up call (which also
captures the chain's CUDA graph) comes first.  Each repetition gets fresh LR
inputs made from ``--seed`` and staged on the card before its timer; the
chains' starting noise is drawn inside the call from a generator seeded per
repetition.  A repetition's time is the host's wall time around the call
and a synchronize, with the CUDA-event time of the same span beside it.

Prints one JSON line: ``metric``, ``value`` (slices/s per GPU: slices served
over the summed wall times), ``unit``, ``per_rep_blocked_ms``,
``per_rep_stdev_ms``, ``per_rep_event_ms``, and ``device`` /
``power_limit`` from nvidia-smi.
``--device cpu`` runs a tiny configuration of the plain PyTorch path (a
smoke test of the entry point; its numbers are no device's; for the latent
chain the JAX bench's ``cpu_smoke`` sizes).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def nvidia_smi() -> tuple[str, str]:
    """(card name, power limit) as nvidia-smi prints them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    return name, limit


# (size, steps, repeats, chains a call) of each pipeline, unless given
DEFAULTS = {"resdiff": (256, 50, 6, 8), "latent": (512, 20, 4, 1)}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="resdiff", choices=sorted(DEFAULTS))
    ap.add_argument("--adapter", action="store_true", help="latent: the T2I-Adapter mode instead of ControlNet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, help="LR size (default 256 resdiff, 512 latent)")
    ap.add_argument("--steps", type=int, help="sampler steps (default 50 resdiff, 20 latent)")
    ap.add_argument("--repeats", type=int, help="timed calls (default 6 resdiff, 4 latent)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--fast", type=int, default=8,
                    help="K/V pool factor at the large cross-attention sites (0: the exact profile)")
    ap.add_argument("--fast-min-tokens", type=int, default=4096,
                    help="smallest cross-attention site (tokens) whose K/V are pooled")
    ap.add_argument("--int8", action="store_true",
                    help="resdiff: the int8 profile (the interior ResnetBlock 3x3 convs in dynamic int8)")
    ap.add_argument("--no-precompute-cond", action="store_true",
                    help="latent: embed the ControlNet's condition image inside every step, not once a chain")
    fuse = ap.add_mutually_exclusive_group()
    fuse.add_argument("--fused", action="store_true",
                      help="latent: the fused UNet+ControlNet encoder towers (the default when the configs match)")
    fuse.add_argument("--no-fused", action="store_true",
                      help="latent: the two encoder towers one after the other")
    ap.add_argument("--chains", type=int, help="chains of --batch slices a call (default 8 resdiff, 1 latent)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the inputs and of the chains' noise")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (a tiny smoke configuration)")
    ap.add_argument("--no-graph", action="store_true", help="run the chains eagerly instead of as a CUDA graph")
    args = ap.parse_args(argv)
    for name, value in zip(("size", "steps", "repeats", "chains"), DEFAULTS[args.pipeline]):
        if getattr(args, name) is None:
            setattr(args, name, value)
    return args


def resdiff_pipeline(args, torch, device, dtype):
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    unet_kwargs = {}
    if device.type == "cpu":
        args.batch, args.size, args.steps, args.repeats, args.chains = 1, 32, 2, 1, 2
        unet_kwargs = dict(inner_channel=8, norm_groups=4)
    torch.manual_seed(0)
    cnn = SimpleCNN(device=device).to(dtype)
    torch.manual_seed(1)
    unet = ResDiffUNet(image_size=args.size, ca_kv_pool=args.fast, ca_kv_pool_min_tokens=args.fast_min_tokens,
                       conv_int8=args.int8, device=device, **unet_kwargs).to(dtype)
    pipe = ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device=device, cuda_graph=not args.no_graph)
    profile = f", fast kv_pool={args.fast}" if args.fast > 1 else ", exact"
    if args.fast > 1 and args.fast_min_tokens != 4096:
        profile += f", min_tokens={args.fast_min_tokens}"
    if args.int8:
        profile += ", int8 convs"
    metric = (f"ResDiff SR slices/sec/gpu ({args.steps}-step DDIM {args.size}x{args.size}, bs={args.batch}, "
              f"{args.dtype}{profile}, {max(args.chains, 1)} chains/call, "
              f"{'CUDA graph' if pipe.cuda_graph else 'eager'})")
    return pipe, metric


def latent_pipeline(args, torch, device, dtype):
    """SD1.5 widths (the JAX bench's ``cpu_smoke`` sizes on the CPU), random weights from ``--seed``."""
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.adapter import T2IAdapter
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.pipelines.latent import LatentSRPipeline

    unet_kw, vae_kw, ad_kw, ctx_shape = {}, {}, {}, (1, 77, 768)
    if device.type == "cpu":
        args.batch, args.size, args.steps, args.repeats, args.chains = 1, 64, 2, 1, 1
        unet_kw = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
        vae_kw, ad_kw, ctx_shape = dict(block_out_channels=(8, 8, 16, 16)), dict(channels=(8, 16, 16, 16)), (1, 7, 16)
    torch.manual_seed(args.seed)
    unet = SDUNet(**unet_kw, device=device).to(dtype)
    torch.manual_seed(args.seed + 1)
    side = (T2IAdapter(**ad_kw, device=device) if args.adapter else ControlNet(**unet_kw, device=device)).to(dtype)
    torch.manual_seed(args.seed + 2)
    vae = AutoencoderKL(**vae_kw, device=device).to(dtype)
    prompt = torch.randn(ctx_shape, generator=torch.Generator().manual_seed(args.seed + 3)).to(dtype)
    fused = True if args.fused else False if args.no_fused else None
    pipe = LatentSRPipeline(unet, None if args.adapter else side, vae, sd15_schedule(), prompt,
                            precompute_cond=not args.no_precompute_cond, fused_towers=fused,
                            adapter=side if args.adapter else None, device=device, cuda_graph=not args.no_graph)
    f = args.size // 8
    towers = ("" if args.adapter else ", fused towers" if pipe.fused_towers else ", sequential towers"
              + ("" if pipe.precompute_cond else ", condition embedded every step"))
    metric = (f"Latent SR slices/sec/gpu ({args.steps}-step {'T2I-Adapter' if args.adapter else 'ControlNet'}+SDUNet"
              f"+VAE, {args.size}x{args.size} cond, {f}x{f} latents, bs={args.batch}, {args.dtype}{towers}, "
              f"{max(args.chains, 1)} chains/call, {'CUDA graph' if pipe.cuda_graph else 'eager'})")
    return pipe, metric


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mrisr_torch.device import resolve_device

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    build = latent_pipeline if args.pipeline == "latent" else resdiff_pipeline
    pipe, metric = build(args, torch, device, dtype)
    G = max(args.chains, 1)
    shape = (G, args.batch, args.size, args.size, 1)
    rng = np.random.default_rng(args.seed)

    def fresh(rep):
        lr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(args.seed * 1000 + rep)
        return lr, gen

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    lr, gen = fresh(-1)  # warm-up (and capture)
    out = pipe.super_resolve_many(lr, gen, args.steps)
    sync()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the warm-up chains gave non-finite output")

    per_rep_ms, per_rep_event_ms = [], []
    for rep in range(args.repeats):
        lr, gen = fresh(rep)
        sync()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = pipe.super_resolve_many(lr, gen, args.steps)
        if cuda:
            end.record()
        sync()
        per_rep_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            per_rep_event_ms.append(start.elapsed_time(end))

    value = args.batch * G * args.repeats / (sum(per_rep_ms) / 1e3)
    name, limit = nvidia_smi() if cuda else ("cpu", None)
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "slices/sec/gpu",
        "per_rep_blocked_ms": per_rep_ms,
        "per_rep_stdev_ms": float(np.std(per_rep_ms)),
        "per_rep_event_ms": per_rep_event_ms or None,
        "cuda_graph": pipe.cuda_graph,
        "device": name,
        "power_limit": limit,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
