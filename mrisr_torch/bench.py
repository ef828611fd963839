"""Serving throughput of the port: the ResDiff 50-step DDIM chain at 256², slices per second per GPU.

Run from the repository root on a machine with a CUDA card::

    python3 -m mrisr_torch.bench                 # fast profile (--fast 8), 8 chains a call, CUDA graph
    python3 -m mrisr_torch.bench --fast 0        # exact profile
    python3 -m mrisr_torch.bench --no-graph      # the same chains run eagerly, for the A/B

The workload is the one ``bench.py`` times for the JAX package: SimpleCNN +
ResDiffUNet at full width with random weights from fixed seeds, cast to
``--dtype``, ``--chains`` G chains of ``--batch`` slices a call through
``ResDiffPipeline.super_resolve_many``.  One warm-up call (which also
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
smoke test of the entry point; its numbers are no device's).
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


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--fast", type=int, default=8,
                    help="K/V pool factor at the large cross-attention sites (0: the exact profile)")
    ap.add_argument("--fast-min-tokens", type=int, default=4096,
                    help="smallest cross-attention site (tokens) whose K/V are pooled")
    ap.add_argument("--chains", type=int, default=8, help="chains of --batch slices a call")
    ap.add_argument("--seed", type=int, default=0, help="seed of the inputs and of the chains' noise")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (a tiny smoke configuration)")
    ap.add_argument("--no-graph", action="store_true", help="run the chains eagerly instead of as a CUDA graph")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mrisr_torch.device import resolve_device
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    device = resolve_device(args.device)
    unet_kwargs = {}
    if device.type == "cpu":
        args.batch, args.size, args.steps, args.repeats, args.chains = 1, 32, 2, 1, 2
        unet_kwargs = dict(inner_channel=8, norm_groups=4)
    dtype = getattr(torch, args.dtype)
    torch.manual_seed(0)
    cnn = SimpleCNN(device=device).to(dtype)
    torch.manual_seed(1)
    unet = ResDiffUNet(image_size=args.size, ca_kv_pool=args.fast, ca_kv_pool_min_tokens=args.fast_min_tokens,
                       device=device, **unet_kwargs).to(dtype)
    pipe = ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device=device, cuda_graph=not args.no_graph)
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
    out = pipe.super_resolve_many(lr, gen, num_steps=args.steps)
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
        out = pipe.super_resolve_many(lr, gen, num_steps=args.steps)
        if cuda:
            end.record()
        sync()
        per_rep_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            per_rep_event_ms.append(start.elapsed_time(end))

    value = args.batch * G * args.repeats / (sum(per_rep_ms) / 1e3)
    name, limit = nvidia_smi() if cuda else ("cpu", None)
    profile = f", fast kv_pool={args.fast}" if args.fast > 1 else ", exact"
    if args.fast > 1 and args.fast_min_tokens != 4096:
        profile += f", min_tokens={args.fast_min_tokens}"
    print(json.dumps({
        "metric": (f"ResDiff SR slices/sec/gpu ({args.steps}-step DDIM {args.size}x{args.size}, bs={args.batch}, "
                   f"{args.dtype}{profile}, {G} chains/call, {'CUDA graph' if pipe.cuda_graph else 'eager'})"),
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
