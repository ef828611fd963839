"""Command-line interface of the port (port of ``mrisr_tpu/cli.py``):

    python -m mrisr_torch.cli train-mnist        --mode {regression,ddpm} ...
    python -m mrisr_torch.cli train-cnn          [--config c.yaml] ...
    python -m mrisr_torch.cli train-resdiff      [--config c.yaml] ...
    python -m mrisr_torch.cli train-latent       --mode {controlnet,lora,adapter} ...
    python -m mrisr_torch.cli build-cache        --out cache.bin ...
    python -m mrisr_torch.cli sr-volume          --checkpoint DIR --input vol.nii.gz --output sr.nii
    python -m mrisr_torch.cli convert-weights    --model unet --input m.safetensors --output unet.npz
    python -m mrisr_torch.cli preprocess-slices  --data-dir BIDS --out DIR
    python -m mrisr_torch.cli export-png         --source DIR/axial --dest DIR
    python -m mrisr_torch.cli evaluate           --gen DIR --gt DIR [--state progress.json]
    python -m mrisr_torch.cli build-index        --root DICOM --out index.json
    python -m mrisr_torch.cli stats              --data-dir BIDS [--out stats.json]
    python -m mrisr_torch.cli report             --data-dir BIDS --out DIR
    python -m mrisr_torch.cli parity             --out PARITY.json ...
    python -m mrisr_torch.cli parity-latent      --out PARITY_LATENT.json ...
    python -m mrisr_torch.cli bench              [--cpu-smoke]

Flags, defaults and the ``--config`` precedence (a flag given on the command
line > the config file > the parser's default) are the reference's.  Every
command that computes on a device runs on the CUDA card, or raises without
one; ``--cpu`` runs it on the CPU.  ``convert-weights``, ``export-png``,
``build-index``, ``stats`` and ``report`` are host work.  On the card the
training step is one CUDA graph replayed per step (``train/steps.py``) and
validation runs the graphed ``ResDiffPipeline``.  Checkpoints are the port's
own (``utils/checkpoint.py``); the JAX CLI's Orbax checkpoints are not read.
``convert-weights`` writes the reference's ``.npz`` (a Flax-layout tree), which
``train-latent --weights-dir`` reads in both packages.  ``parity`` and
``parity-latent`` run the fidelity harness (``eval/parity.py``); its
``--resume-ckpt`` also takes the JAX harness's ``--ckpt`` file.  ``bench``
runs ``mrisr_torch.bench`` in this process (``--cpu-smoke``: ``--device
cpu``) and prints its JSON line.

A resumed run takes up the batch sequence where it stopped (the loader runs
from the global batch number) and each step draws from
``step_generator(seed, step)``, so ``--resume`` continues the run bitwise
(on a card, with ``torch.backends.cudnn.deterministic`` set: cuDNN's default
algorithms may sum in another order from run to run).
Each training command ends by logging its throughput to ``metrics.jsonl``:
steps per second (of the whole run, and of the loop after its first step
without validation), the loader thread's time to make a batch, the time
the loop waited for one and how often it found none ready, the step's graph
captures and replays, and (on the card) the device time of a step and a
graphed step's forward, backward and update in its last replay
(``stage_ms_*``).  ``sr-volume`` prints one line of its chain's stages in
the last replay (device ms) and its captures and replays.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _add_common(p):
    p.add_argument("--config", default=None, help="YAML/JSON config file")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the CUDA card)")
    p.add_argument("--seed", type=int, default=42)


def _add_train_common(p):
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    p.add_argument("--val-every", type=int, default=0, help="validate every N steps (0=off)")
    p.add_argument("--val-steps", type=int, default=20, help="sampler steps at validation")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype (params stay fp32)")
    p.add_argument("--cache", default=None, help="native slice-cache file to train from")
    p.add_argument("--remat", action="store_true", help="rematerialise the forward in backward (larger batches)")


# typed-config field -> CLI argument name (precedence: CLI flag > config file > parser default)
_CONFIG_TO_ARG = {
    ("data", "resolution"): "resolution",
    ("data", "batch_size"): "batch",
    ("data", "data_dir"): "data_dir",
    ("train", "max_steps"): "steps",
    ("train", "seed"): "seed",
    ("train", "val_every"): "val_every",
    ("train", "mixed_precision"): "precision",
    ("train", "gradient_accumulation"): "grad_accum",
    ("train", "output_dir"): "out",
    ("train", "proportion_empty_prompts"): "proportion_empty_prompts",
    ("optim", "lr"): "lr",
    ("optim", "warmup_steps"): "warmup",
}


def _apply_config(args, subparser):
    """Fill args from --config for every flag the user left at its default."""
    if not getattr(args, "config", None):
        return args
    from mrisr_torch.config import load_config

    cfg = load_config(args.config)
    defaults = {a.dest: a.default for a in subparser._actions}
    for (section, field), dest in _CONFIG_TO_ARG.items():
        if not hasattr(args, dest):
            continue
        if getattr(args, dest) != defaults.get(dest):
            continue  # explicit CLI flag wins
        sec = getattr(cfg, section, None)
        if sec is None or not hasattr(sec, field):
            continue
        val = getattr(sec, field)
        if val != getattr(type(sec)(), field):  # only values the file set
            setattr(args, dest, val)
    return args


def build_parser() -> tuple[argparse.ArgumentParser, dict]:
    """The parser and its subparsers by name (``_apply_config`` reads a subparser's defaults)."""
    ap = argparse.ArgumentParser(prog="mrisr_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    subparsers = {}

    def add(name, **kw):
        subparsers[name] = p = sub.add_parser(name, **kw)
        return p

    p = add("train-mnist", help="MNIST 14->28 toy SR")
    _add_common(p)
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    p.add_argument("--mode", choices=["regression", "ddpm"], default="ddpm")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out", default="./outputs/mnist")

    p = add("train-cnn", help="Stage-1 SimpleCNN training")
    _add_common(p)
    _add_train_common(p)
    p.add_argument("--index", required=False, help="patient index JSON")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--out", default="./outputs/cnn")

    p = add("train-resdiff", help="Stage-2 ResDiff diffusion training")
    _add_common(p)
    _add_train_common(p)
    p.add_argument("--index", required=False)
    p.add_argument("--cnn-checkpoint", default=None)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--out", default="./outputs/resdiff")

    p = add("train-latent", help="PEFT training on the SD1.5 latent stack (ControlNet / LoRA / T2I-Adapter)")
    _add_common(p)
    _add_train_common(p)
    p.add_argument("--mode", choices=["controlnet", "lora", "adapter"], default="controlnet")
    p.add_argument("--index", required=False)
    p.add_argument("--weights-dir", default=None, help="dir of converted .npz params (unet.npz, vae.npz)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--lora-rank", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--proportion-empty-prompts", type=float, default=0.1)
    p.add_argument("--tiny", action="store_true", help="tiny tower config (CPU)")
    p.add_argument("--out", default="./outputs/latent")

    p = add("build-cache", help="materialise a dataset into the native slice cache")
    _add_common(p)
    p.add_argument("--index", required=False, help="patient index JSON (phantom fallback)")
    p.add_argument("--out", required=True, help="cache file path")
    p.add_argument("--resolution", type=int, default=256)

    p = add("sr-volume", help="NIfTI volume -> SR NIfTI volume")
    _add_common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--chains", type=int, default=None,
                   help="chains per call (default env MRISR_VOLUME_CHAINS or 1)")

    p = add("convert-weights", help="torch/diffusers checkpoint (.safetensors/.bin) -> flax params .npz")
    p.add_argument("--model", required=True, choices=["vae", "unet", "controlnet", "clip", "clip-proj"])
    p.add_argument("--input", required=True, help=".safetensors or torch .bin/.pt")
    p.add_argument("--output", required=True, help="output .npz params file")
    p.add_argument("--num-layers", type=int, default=None, help="CLIP tower depth")

    p = add("preprocess-slices", help="BIDS NIfTI pairs -> per-slice npz")
    _add_common(p)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--axis", type=int, default=2)

    p = add("export-png", help="npz slices -> PNG + metadata.jsonl")
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)

    p = add("evaluate", help="folder-vs-folder MRI metrics")
    p.add_argument("--gen", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--state", default=None, help="progress file enabling resumable evaluation")
    p.add_argument("--cpu", action="store_true", help="compute the metrics on the CPU (the default is the CUDA card)")

    p = add("build-index", help="DICOM tree -> patient index JSON")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)

    p = add("stats", help="BIDS dataset analytics (subject/session overlap)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default=None, help="optional JSON report path")

    p = add("report", help="visual dataset report (LR|HR montages + stats)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--axis", type=int, default=2)
    p.add_argument("--max-subjects", type=int, default=None)

    p = add("parity", help="fidelity-parity harness (hermetic configs)")
    _add_common(p)
    p.add_argument("--out", default="PARITY_RUN.json")
    p.add_argument("--mnist-steps", type=int, default=300)
    p.add_argument("--phantom-steps", type=int, default=400)
    p.add_argument("--resdiff-steps", type=int, default=300)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--index", default=None, help="FastMRI index for the real-data anchor")
    p.add_argument("--n-train", type=int, default=64, help="phantom training-set size")
    p.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--batch", type=int, default=8, help="phantom training batch size")
    p.add_argument("--plain-phantoms", action="store_true", help="legacy smooth-blob phantoms (no texture/lines)")
    p.add_argument("--degrade-scale", type=float, default=4.0,
                   help="degradation scale (blur sigma = 0.5*scale + bicubic down/up)")
    p.add_argument("--fast", type=int, default=0, help="sample with the fast CA profile (K/V pool factor)")
    p.add_argument("--skip-mnist", action="store_true", help="skip the MNIST leg (phantom-only runs)")
    p.add_argument("--texture-mode", default="recoverable", choices=["recoverable", "legacy"],
                   help="textured-phantom information structure (see eval/parity.py::_phantom_batches)")
    p.add_argument("--eval-every", type=int, default=0, help="run a 50-step sampling eval every N resdiff steps")
    p.add_argument("--ckpt", default=None,
                   help="save EMA+train params and the optimizer state here at every eval (crash insurance)")
    p.add_argument("--resume-ckpt", default=None,
                   help="resume resdiff training from a --ckpt file (this package's or the JAX harness's)")
    p.add_argument("--inner-channel", type=int, default=16, help="resdiff UNet width for the phantom leg")
    p.add_argument("--ema-decay", type=float, default=0.99,
                   help="EMA decay for the phantom resdiff leg (use 0.999+ for runs >20k steps)")
    p.add_argument("--n-test", type=int, default=16,
                   help="held-out phantom evaluation set size (use a multiple of --batch; >=64 for "
                        "decision-grade profile-fidelity CIs)")
    p.add_argument("--sample-seeds", default="2",
                   help="comma-separated sampler seeds; each profile is sampled n_test x len(seeds) times "
                        "with paired noise")
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="training steps per chunk (0 = follow --eval-every)")
    p.add_argument("--sample-steps", default="10,50,250,1000",
                   help="comma-separated sampling-chain lengths for the final sweep")

    p = add("parity-latent", help="latent-path (ControlNet/LoRA) trained-model fidelity leg "
                                  "(phantom scale; reference src/adapters/res_srdiff.py:36-105)")
    _add_common(p)
    p.add_argument("--out", default="PARITY_LATENT.json")
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-test", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--vae-steps", type=int, default=4000)
    p.add_argument("--base-steps", type=int, default=6000)
    p.add_argument("--cn-steps", type=int, default=3000)
    p.add_argument("--lora-steps", type=int, default=3000)
    p.add_argument("--inference-steps", type=int, default=20)
    p.add_argument("--sample-seeds", default="2,3")
    p.add_argument("--degrade-scale", type=float, default=4.0)
    p.add_argument("--texture-mode", default="recoverable", choices=["recoverable", "legacy"])
    p.add_argument("--lora-rank", type=int, default=4)
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="training steps per chunk through the *_many wrappers (0 = per-step loop)")
    p.add_argument("--vae-width", type=int, default=16, help="phantom-scale VAE base width (blocks w,2w,4w)")
    p.add_argument("--unet-width", type=int, default=32,
                   help="phantom-scale SDUNet/ControlNet base width (w,2w,2w,2w)")
    p.add_argument("--prediction-type", default="epsilon", choices=["epsilon", "sample"],
                   help="'epsilon' (the reference SD1.5 setting) or 'sample' (the model predicts x0: the stable "
                        "choice for from-scratch phantom-scale training)")
    p.add_argument("--adapter-steps", type=int, default=0, help="T2I-Adapter leg training steps (0 = skip the leg)")
    p.add_argument("--cn-lora-steps", type=int, default=0,
                   help="combined ControlNet+LoRA leg training steps (the reference notebook's configuration; "
                        "0 = skip)")
    p.add_argument("--lora-ranks", default="",
                   help="comma-separated extra LoRA ranks for the rank sweep (each trained --lora-steps)")
    p.add_argument("--extra-sample-steps", default="",
                   help="comma-separated extra inference chain lengths (e.g. 50) sampled for the PEFT rows")
    p.add_argument("--cache-latents", action="store_true",
                   help="precompute VAE posterior moments once and sample latents in-step")
    p.add_argument("--vae-chunk-steps", type=int, default=0,
                   help="separate training chunk for the VAE leg (0 = --chunk-steps)")

    p = add("bench", help="throughput benchmark")
    p.add_argument("--cpu-smoke", action="store_true", help="the bench's tiny CPU configuration (--device cpu)")
    return ap, subparsers


def _device(args):
    from mrisr_torch.device import resolve_device

    return resolve_device("cpu" if args.cpu else "cuda")


def _val_batch_from(ds, n=4):
    import numpy as np

    samples = [ds[i] for i in range(min(n, len(ds)))]
    return {"lr": np.stack([np.asarray(s["lr"], np.float32) for s in samples]),
            "hr": np.stack([np.asarray(s["hr"], np.float32) for s in samples])}


def _to_device(x, device):
    import torch

    return torch.as_tensor(x).to(device, torch.float32, non_blocking=True)


class _Throughput:
    """Steps per second (of the whole run, and of the loop after its first step with validation left out),
    and from the program's counters over the loop (``utils/profiling.py``): the loader thread's time to make
    a batch, the loop's wait for one, the waits that found no batch ready, the step's graph captures and
    replays, and (on a card) each step's device time and a graphed step's stages in its last replay."""

    def __init__(self, device):
        from mrisr_torch.utils import profiling

        self.device, self.t0, self.steps, self.events = device, time.perf_counter(), 0, []
        self.first_end, self.excluded = None, 0.0
        self.start = profiling.counters()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, run):
        import torch

        self.steps += 1
        if self.device.type != "cuda":
            out = run()
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            self.events.append((start, end))
        if self.steps == 1:
            self._sync()
            self.first_end = time.perf_counter()
        return out

    def excluding(self, run):
        """``run()`` (validation), its time left out of the loop's rate."""
        self._sync()
        t0 = time.perf_counter()
        out = run()
        self._sync()
        self.excluded += time.perf_counter() - t0
        return out

    def record(self) -> dict:
        from mrisr_torch.utils import profiling

        self._sync()
        end = time.perf_counter()
        now = profiling.counters()
        since = lambda k: now.get(k, 0) - self.start.get(k, 0)  # noqa: E731
        loop = end - self.first_end - self.excluded if self.first_end is not None else 0.0
        rec = {"steps": self.steps, "steps_per_s": self.steps / (end - self.t0),
               "loop_steps_per_s_after_first": (self.steps - 1) / loop if loop > 0 else 0.0,
               "data_make_ms_per_batch": 1e3 * since("loader.make_s") / max(since("loader.made"), 1),
               "data_wait_ms_per_batch": 1e3 * since("loader.wait_s") / max(since("loader.waits"), 1),
               "loader_starved": since("loader.starved"),
               "graph_captures": since("train_step.captures"), "graph_replays": since("train_step.replays")}
        if self.events:
            ms = [s.elapsed_time(e) for s, e in self.events]
            rec.update(step_device_ms=sum(ms) / len(ms), step_device_ms_after_first=sum(ms[1:]) / max(len(ms) - 1, 1))
        if rec["graph_replays"]:
            rec.update({f"stage_ms_{name.removeprefix('train.')}": ms
                        for name, ms in profiling.stage_ms("train_step").items()})
        return rec


def _train_mnist(args):
    """The MNIST toy SR (Adam 1e-3): regression, or conditional DDPM with the class labels over the 1000-step
    linear noise schedule; metrics every 50 steps, a checkpoint at the end."""
    import torch

    from mrisr_torch.data.datasets import MNISTSRDataset
    from mrisr_torch.data.loader import Loader
    from mrisr_torch.diffusion.schedules import mnist_schedule
    from mrisr_torch.models.mnist_unet import MNISTUNet
    from mrisr_torch.ops.resize import interpolate_like_torch
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_mnist_ddpm_step, make_mnist_regression_step, step_generator
    from mrisr_torch.utils.checkpoint import CheckpointManager
    from mrisr_torch.utils.logging import MetricLogger

    device = _device(args)
    ds = MNISTSRDataset(args.data_dir)
    loader = Loader(ds, batch_size=args.batch, shuffle=True, seed=args.seed, pin_memory=device.type == "cuda")
    torch.manual_seed(args.seed)
    model = MNISTUNet(num_classes=10, in_channels=1 if args.mode == "regression" else 2, device=device)
    state = create_train_state(model, make_optimizer(1e-3), device=device)
    mgr = CheckpointManager(f"{args.out}/ckpt")
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state, in_place=True)
        print(f"resumed from step {state.step}")
    step = (make_mnist_regression_step(model, device) if args.mode == "regression"
            else make_mnist_ddpm_step(model, mnist_schedule(1000), device))
    logger = MetricLogger(args.out)
    i = state.step
    meter = _Throughput(device)
    batches = loader.batches(start=i)
    while i < args.steps:
        batch = next(batches)
        lr = _to_device(batch["lr"], device)
        lr_up = interpolate_like_torch(lr.permute(0, 3, 1, 2), (28, 28)).permute(0, 2, 3, 1)
        b = {"hr": _to_device(batch["hr"], device), "lr_up": lr_up,
             "label": torch.as_tensor(batch["label"]).to(device, torch.int64)}
        gen = step_generator(args.seed, i, device)
        state, m = meter.timed(lambda: step(state, b, gen))
        if i % 50 == 0:
            logger.log(i, m)
        i += 1
    batches.close()
    logger.log(i, meter.record(), prefix="run_")
    mgr.save(i, state, force=True)
    mgr.close()
    print(f"done; checkpoint at {args.out}/ckpt")
    return {"state": state, "step": step}


def _train_cnn(args):
    import torch
    from torch.func import functional_call

    from mrisr_torch.data.loader import Loader
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.train.precision import get_policy
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_cnn_train_step
    from mrisr_torch.train.validation import ValidationHook
    from mrisr_torch.utils.checkpoint import CheckpointManager
    from mrisr_torch.utils.logging import MetricLogger

    device = _device(args)
    ds = _resolve_dataset(args)
    loader = Loader(ds, batch_size=args.batch, shuffle=True, seed=args.seed, pin_memory=device.type == "cuda")
    torch.manual_seed(args.seed)
    cnn = SimpleCNN(device=device)
    state = create_train_state(cnn, make_optimizer(1e-4, grad_accum=args.grad_accum), device=device)
    mgr = CheckpointManager(f"{args.out}/ckpt")
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state, in_place=True)
        print(f"resumed from step {state.step}")
    step = make_cnn_train_step(cnn, get_policy(args.precision), device)
    logger = MetricLogger(args.out)
    hook = None
    if args.val_every > 0:
        @torch.no_grad()
        def sample_fn(params, lr, generator):
            x = _to_device(lr, device)
            b, h, w, _ = x.shape
            return functional_call(cnn, params, (x.reshape(b, 1, h, w),)).reshape(b, h, w, 1)

        hook = ValidationHook(sample_fn, _val_batch_from(ds), f"{args.out}/val", every=args.val_every,
                              data_in_unit_range=True)
    i = state.step
    meter = _Throughput(device)
    batches = loader.batches(start=i)
    while i < args.steps:
        batch = next(batches)
        b = {"lr": _to_device(batch["lr"], device), "hr": _to_device(batch["hr"], device)}
        state, m = meter.timed(lambda: step(state, b))
        if i % 20 == 0:
            logger.log(i, m)
        i += 1
        if hook is not None:
            vm = meter.excluding(lambda: hook.maybe_run(i, state.params, None))
            if vm:
                logger.log(i, vm)
                mgr.save(i, state)
    batches.close()
    logger.log(i, meter.record(), prefix="run_")
    mgr.save(i, state, force=True)
    mgr.close()
    return {"state": state, "step": step}


def _train_resdiff(args):
    import torch

    from mrisr_torch.data.loader import Loader
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.train.precision import get_policy
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_resdiff_train_step, step_generator
    from mrisr_torch.utils.checkpoint import CheckpointManager
    from mrisr_torch.utils.logging import MetricLogger

    device = _device(args)
    ds = _resolve_dataset(args)
    loader = Loader(ds, batch_size=args.batch, shuffle=True, seed=args.seed, pin_memory=device.type == "cuda")
    torch.manual_seed(args.seed)
    cnn = SimpleCNN(device=device).eval()
    if args.cnn_checkpoint:
        cnn_state = create_train_state(cnn, make_optimizer(1e-4), device=device)
        mgr0 = CheckpointManager(args.cnn_checkpoint)
        cnn.load_state_dict(mgr0.restore(cnn_state).params)
        mgr0.close()
    unet = ResDiffUNet(image_size=args.resolution, device=device)
    sched = resdiff_schedule(1000)
    state = create_train_state(unet, make_optimizer(1e-5, grad_accum=args.grad_accum), ema_decay=0.999,
                               device=device)
    mgr = CheckpointManager(f"{args.out}/ckpt")
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state, in_place=True)
        print(f"resumed from step {state.step}")
    step = make_resdiff_train_step(unet, sched, get_policy(args.precision), remat=args.remat, device=device)
    logger = MetricLogger(args.out)

    hook, pipe = None, None
    if args.val_every > 0:
        from mrisr_torch.pipelines.resdiff import ResDiffPipeline
        from mrisr_torch.train.validation import ValidationHook

        # The pipeline's own UNet: the EMA weights are copied into it in place, so its CUDA graph stays valid.
        pipe = ResDiffPipeline(cnn, ResDiffUNet(image_size=args.resolution, device=device), sched, device=device)
        pipe_params = dict(pipe.unet.named_parameters())

        @torch.no_grad()
        def sample_fn(params, lr, generator):
            torch._foreach_copy_([pipe_params[k] for k in params], list(params.values()))
            return pipe.super_resolve(_to_device(lr, device), generator, num_steps=args.val_steps)

        hook = ValidationHook(sample_fn, _val_batch_from(ds), f"{args.out}/val", every=args.val_every,
                              data_in_unit_range=True)

    i = state.step
    meter = _Throughput(device)
    batches = loader.batches(start=i)
    while i < args.steps:
        batch = next(batches)
        lr, hr = _to_device(batch["lr"], device), _to_device(batch["hr"], device)
        with torch.no_grad():
            b, h, w, _ = lr.shape
            sr = cnn(lr.reshape(b, 1, h, w)).reshape(b, h, w, 1)
        gen = step_generator(args.seed, i, device)
        state, m = meter.timed(lambda: step(state, {"sr": sr, "hr": hr}, gen))
        if i % 100 == 0:
            logger.log(i, m)
        if i > 0 and i % 2000 == 0:
            mgr.save(i, state)
        i += 1
        if hook is not None:
            val_params = state.ema_params if state.ema_params is not None else state.params
            vm = meter.excluding(lambda: hook.maybe_run(i, val_params, step_generator(args.seed + 777, i, device)))
            if vm:
                logger.log(i, vm)
    batches.close()
    logger.log(i, meter.record(), prefix="run_")
    mgr.save(i, state, force=True)
    mgr.close()
    return {"state": state, "step": step, "pipeline": pipe}


LATENT_TINY = dict(unet=dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16),
                   vae=dict(block_out_channels=(8, 8, 16, 16)), context=(7, 16))
LATENT_SD15 = dict(unet={}, vae={}, context=(77, 768))
LATENT_CKPT_EVERY = 200  # the reference's checkpointing_steps


def _train_latent(args):
    """PEFT training of the latent family (the reference's hyperparameters: lr 1e-5, cosine schedule with 500
    warmup steps, AdamW, gradient-norm clip 1.0, CFG dropout 0.1), fp32 weights and states, a fixed random
    prompt embedding.  The modules are random from ``--seed`` unless ``--weights-dir`` holds converted
    ``unet.npz`` / ``vae.npz``; a ``unet.npz`` also gives the UNet's depth and widths (``sd_unet_shape``; the
    reference builds SD1.5's and takes only a tree of that shape), and the ControlNet follows the UNet.
    ``--precision``, ``--remat`` and ``--val-every`` are parsed and not acted
    on, as in the reference (a line on stderr names those set)."""
    import torch

    from mrisr_torch.data.loader import Loader
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.adapter import T2IAdapter
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.lora import init_lora_params
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.train import latent
    from mrisr_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from mrisr_torch.train.steps import step_generator
    from mrisr_torch.utils.checkpoint import CheckpointManager
    from mrisr_torch.utils.logging import MetricLogger
    from mrisr_torch.weights import load_flax_params, load_params_npz, sd_unet_shape

    ignored = [flag for flag, on in ((f"--precision {args.precision}", args.precision != "float32"),
                                     ("--remat", args.remat), (f"--val-every {args.val_every}", args.val_every))
               if on]
    if ignored:  # parsed and not acted on, as in the reference
        print(f"train-latent: {', '.join(ignored)} not acted on; it trains in float32", file=sys.stderr)
    device = _device(args)
    cfg = LATENT_TINY if args.tiny else LATENT_SD15
    ctx_len, ctx_dim = cfg["context"]
    trees = {}
    if args.weights_dir:
        from pathlib import Path

        trees = {name: load_params_npz(path) for name in ("unet", "vae")
                 if (path := Path(args.weights_dir) / f"{name}.npz").exists()}
    unet_kw = dict(cfg["unet"])
    if "unet" in trees:  # the UNet takes the depth and widths of the tree it is given
        unet_kw.update(sd_unet_shape(trees["unet"]))
    torch.manual_seed(args.seed)
    unet = SDUNet(**unet_kw, device=device)
    vae = AutoencoderKL(**cfg["vae"], device=device)
    for name, module in (("unet", unet), ("vae", vae)):
        if name in trees:
            load_flax_params(module, trees[name])
    gen = torch.Generator().manual_seed(args.seed)
    prompt = (torch.randn((1, ctx_len, ctx_dim), generator=gen) * 0.02).to(device)
    empty = torch.zeros((1, ctx_len, ctx_dim), device=device)
    sched = sd15_schedule()
    tx = make_optimizer(make_lr_schedule("cosine", args.lr, args.warmup, args.steps), kind="adamw",
                        max_grad_norm=1.0, grad_accum=args.grad_accum)
    if args.mode == "controlnet":
        cn = ControlNet(block_out_channels=unet.block_out_channels, layers_per_block=unet.layers_per_block,
                        heads=unet.heads, context_dim=unet.context_dim, device=device)
        state = create_train_state(cn, tx, device=device)
        make = lambda: latent.make_controlnet_train_step(  # noqa: E731
            unet, cn, vae, sched, prompt, empty, args.proportion_empty_prompts, device=device)
    elif args.mode == "lora":
        lora = init_lora_params(unet, args.lora_rank, generator=torch.Generator(device).manual_seed(args.seed))
        state = create_train_state(latent.lora_params(lora), tx, device=device)
        make = lambda: latent.make_lora_train_step(  # noqa: E731
            unet, vae, sched, prompt, empty_embeds=empty, proportion_empty_prompts=args.proportion_empty_prompts,
            device=device)
    else:
        adapter = T2IAdapter(channels=unet.block_out_channels, device=device)
        state = create_train_state(adapter, tx, device=device)
        make = lambda: latent.make_adapter_train_step(unet, adapter, vae, sched, prompt, device=device)  # noqa: E731
    mgr = CheckpointManager(f"{args.out}/ckpt")
    if args.resume and mgr.latest_step() is not None:
        mgr.restore(state, in_place=True)
        print(f"resumed from step {state.step}")
    step = make()
    logger = MetricLogger(args.out)
    ds = _resolve_dataset(args)
    loader = Loader(ds, batch_size=args.batch, shuffle=True, seed=args.seed, pin_memory=device.type == "cuda")
    i = state.step
    meter = _Throughput(device)
    batches = loader.batches(start=i)
    while i < args.steps:
        batch = next(batches)
        b = {"lr": _to_device(batch["lr"], device), "hr": _to_device(batch["hr"], device)}
        gen = step_generator(args.seed, i, device)
        state, m = meter.timed(lambda: step(state, b, gen))
        if i % 50 == 0:
            logger.log(i, m)
        if i > 0 and i % LATENT_CKPT_EVERY == 0:
            mgr.save(i, state)
        i += 1
    batches.close()
    logger.log(i, meter.record(), prefix="run_")
    mgr.save(i, state, force=True)
    mgr.close()
    return {"state": state, "step": step, "unet": unet, "vae": vae}


def _build_cache(args):
    from mrisr_torch.data.slicecache import build_cache_from_dataset

    ds = _resolve_dataset(args)
    cache = build_cache_from_dataset(ds, args.out)
    print(f"cached {cache.n} slices ({cache.height}x{cache.width}) -> {args.out}")
    cache.close()
    return {}


class Phantom:
    """Synthetic phantom slices (six Gaussian blobs, clipped to [0, 1]) and their degraded copies, made from
    ``default_rng(i)``: the data when no index or cache is given."""

    def __init__(self, n: int = 64, res: int = 256):
        import numpy as np

        self.n, self.res = n, res
        yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
        self.grid = (yy, xx)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        from mrisr_torch.data.degrade import simulate_low_res_np

        rng = np.random.default_rng(i)
        yy, xx = self.grid
        r = self.res
        img = np.zeros((r, r), np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(r * 0.2, r * 0.8, 2)
            a, b = rng.uniform(r * 0.05, r * 0.3, 2)
            img += rng.uniform(0.2, 1.0) * np.exp(-(((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2))
        img = np.clip(img, 0, 1)
        lr = simulate_low_res_np(img, 4.0)
        return {"hr": img[..., None], "lr": lr[..., None]}


def _resolve_dataset(args):
    if getattr(args, "cache", None):
        from mrisr_torch.data.slicecache import SliceCacheDataset

        return SliceCacheDataset(args.cache)
    if getattr(args, "index", None):
        from mrisr_torch.data.datasets import FastMRISliceDataset

        return FastMRISliceDataset(json_path=args.index, target_size=(args.resolution, args.resolution))
    return Phantom(res=args.resolution)


def _sr_volume(args):
    import torch

    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline
    from mrisr_torch.pipelines.volume import super_resolve_volume
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.utils import profiling
    from mrisr_torch.utils.checkpoint import CheckpointManager

    device = _device(args)
    torch.manual_seed(args.seed)
    cnn = SimpleCNN(device=device)
    unet = ResDiffUNet(image_size=args.resolution, device=device)
    if args.checkpoint:
        mgr = CheckpointManager(args.checkpoint)
        restored = mgr.restore(create_train_state(unet, make_optimizer(1e-5), device=device))
        unet.load_state_dict(restored.ema_params or restored.params)
        mgr.close()
    pipe = ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device=device)
    chains = args.chains or int(os.environ.get("MRISR_VOLUME_CHAINS", "1"))
    start = profiling.counters()
    out = super_resolve_volume(pipe, args.input, args.output, resolution=args.resolution, batch_size=args.batch,
                               num_steps=args.ddim_steps, seed=args.seed, chain_group=chains)
    print(f"wrote {args.output} shape={out.shape}")
    now = profiling.counters()
    since = {k: now.get(k, 0) - start.get(k, 0) for k in ("resdiff.captures", "resdiff.replays")}
    stages = profiling.stage_ms("resdiff.chain") if since["resdiff.replays"] else {}
    print(" ".join(["chain", *(f"{name.removeprefix('resdiff.')}_ms={ms:.3f}" for name, ms in stages.items()),
                    f"captures={since['resdiff.captures']}", f"replays={since['resdiff.replays']}"]))
    return {"pipeline": pipe, "volume": out}


def _convert_weights(args):
    """The checkpoint read, converted to the reference's Flax-layout tree and saved as ``.npz``; the seconds
    each part took."""
    from mrisr_torch.data.safetensors_io import load_state_dict_any
    from mrisr_torch.models.convert import CONVERTERS, save_params_npz

    t0 = time.perf_counter()
    sd = load_state_dict_any(args.input)
    t1 = time.perf_counter()
    conv = CONVERTERS[args.model]
    params = conv(sd, num_layers=args.num_layers) if args.model in ("clip", "clip-proj") and args.num_layers else conv(sd)
    t2 = time.perf_counter()
    save_params_npz(args.output, params)
    t3 = time.perf_counter()
    print(f"converted {len(sd)} tensors -> {args.output}")
    return {"tensors": len(sd), "read_s": t1 - t0, "convert_s": t2 - t1, "write_s": t3 - t2}


PREPROCESS_SHAPE = (512, 512, 128)  # the reference's MONAI ResizeD


def _preprocess_slices(args):
    """Each BIDS pair read, reoriented to RAS, scaled from 0..1000 to [0, 1], resized to 512x512x128 on the
    device with ``jax.image.resize``'s linear rule, and cut into ``axial/axial_vol_{i:03d}_{s:04d}.npz``."""
    from pathlib import Path

    import numpy as np
    import torch

    from mrisr_torch.data.bids import get_data_dicts
    from mrisr_torch.data.nifti import read_nifti, to_ras
    from mrisr_torch.data.slices import scale_intensity_range, volume_to_slices
    from mrisr_torch.ops.resize import resize_linear

    device = _device(args)
    pairs = get_data_dicts(args.data_dir)
    print(f"found {len(pairs)} paired scans")
    out = Path(args.out) / "axial"
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for i, pair in enumerate(pairs):
        vols = {}
        for k in ("lr", "hr"):
            v = scale_intensity_range(to_ras(read_nifti(pair[k])).data, 0, 1000)
            vols[k] = resize_linear(torch.from_numpy(v).to(device), PREPROCESS_SHAPE).cpu().numpy()
        slices = volume_to_slices(vols["lr"], vols["hr"], args.axis)
        for s, (lr_s, hr_s) in enumerate(slices):
            np.savez_compressed(out / f"axial_vol_{i:03d}_{s:04d}.npz", lr=lr_s, hr=hr_s)
        print(f"vol_{i:03d}: {vols['lr'].shape[args.axis]} slices")
        written.append(len(slices))
    return {"pairs": len(pairs), "slices": written}


def _export_png(args):
    from mrisr_torch.data.export import export_png_dataset

    n = export_png_dataset(args.source, args.dest)
    print(f"exported {n} pairs to {args.dest}")
    return {"pairs": n}


def _evaluate(args):
    from mrisr_torch.eval.metrics import MRIEvaluator

    return {"results": MRIEvaluator(device="cpu" if args.cpu else "cuda").evaluate_folders(
        args.gen, args.gt, state_file=args.state)}


def _build_index(args):
    from mrisr_torch.data.datasets import build_patient_index

    idx = build_patient_index(args.root, args.out)
    print(f"indexed {len(idx)} patients -> {args.out}")
    return {"index": idx}


def _stats(args):
    import json
    from pathlib import Path

    from mrisr_torch.data.bids import dataset_stats

    report = dataset_stats(args.data_dir)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return {"stats": report}


def _report(args):
    from mrisr_torch.data.report import visual_report

    stats = visual_report(args.data_dir, args.out, args.axis, args.max_subjects)
    print(f"wrote {len(stats['montages'])} montages + stats.json -> {args.out}")
    return {"stats": stats}


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x)


def _parity(args):
    import json

    from mrisr_torch.eval.parity import run_parity

    report = run_parity(
        args.out, mnist_steps=args.mnist_steps, phantom_steps=args.phantom_steps, resdiff_steps=args.resdiff_steps,
        res=args.resolution, index_json=args.index, n_train=args.n_train, lr_schedule=args.lr_schedule,
        batch=args.batch, textured=not args.plain_phantoms, degrade_scale=args.degrade_scale,
        ca_kv_pool=args.fast, skip_mnist=args.skip_mnist, texture_mode=args.texture_mode,
        eval_every=args.eval_every, ckpt_path=args.ckpt, resume_ckpt=args.resume_ckpt,
        inner_channel=args.inner_channel, ema_decay=args.ema_decay, n_test=args.n_test,
        sample_seeds=_ints(args.sample_seeds), chunk_steps=args.chunk_steps, sample_steps=_ints(args.sample_steps),
        device=_device(args))
    for k in ("mnist_regression", "phantom_cnn", "phantom_resdiff", "fastmri_cnn"):
        if k in report:
            print(k, json.dumps(report[k]["model"]))
    return {"report": report}


def _parity_latent(args):
    import json
    from pathlib import Path

    from mrisr_torch.eval.parity import run_phantom_latent

    report = run_phantom_latent(
        res=args.resolution, n_train=args.n_train, n_test=args.n_test, batch=args.batch,
        vae_steps=args.vae_steps, base_steps=args.base_steps, cn_steps=args.cn_steps, lora_steps=args.lora_steps,
        num_inference_steps=args.inference_steps, sample_seeds=_ints(args.sample_seeds),
        degrade_scale=args.degrade_scale, texture_mode=args.texture_mode, lora_rank=args.lora_rank,
        chunk_steps=args.chunk_steps, prediction_type=args.prediction_type, vae_width=args.vae_width,
        unet_width=args.unet_width, adapter_steps=args.adapter_steps, cn_lora_steps=args.cn_lora_steps,
        lora_ranks=_ints(args.lora_ranks), extra_sample_steps=_ints(args.extra_sample_steps),
        cache_latents=args.cache_latents, vae_chunk_steps=args.vae_chunk_steps, device=_device(args))
    Path(args.out).write_text(json.dumps(report, indent=2))
    for k in ("bicubic_baseline", "vae_recon_ceiling"):
        print(k, json.dumps(report[k]))
    for k, v in report.items():
        if isinstance(v, dict) and "beats_bicubic" in v:
            print(k, json.dumps(v["mean"]), "beats_bicubic:", v["beats_bicubic"])
    return {"report": report}


def _bench(args):
    from mrisr_torch import bench

    return {"rc": bench.main(["--device", "cpu"] if args.cpu_smoke else [])}


_COMMANDS = {"train-mnist": _train_mnist, "train-cnn": _train_cnn, "train-resdiff": _train_resdiff,
             "train-latent": _train_latent, "build-cache": _build_cache, "sr-volume": _sr_volume,
             "convert-weights": _convert_weights, "preprocess-slices": _preprocess_slices,
             "export-png": _export_png, "evaluate": _evaluate, "build-index": _build_index, "stats": _stats,
             "report": _report, "parity": _parity,
             "parity-latent": _parity_latent, "bench": _bench}


def run(argv=None) -> dict:
    """Parse ``argv`` and run the command; returns what it built or found (the train state and step, the
    pipeline, a command's results)."""
    ap, subparsers = build_parser()
    args = ap.parse_args(argv)
    _apply_config(args, subparsers[args.cmd])
    return _COMMANDS[args.cmd](args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
