"""Command-line interface of the port (port of ``mrisr_tpu/cli.py``):

    python -m mrisr_torch.cli train-cnn      [--config c.yaml] ...
    python -m mrisr_torch.cli train-resdiff  [--config c.yaml] ...
    python -m mrisr_torch.cli build-cache    --out cache.bin ...
    python -m mrisr_torch.cli sr-volume      --checkpoint DIR --input vol.nii.gz --output sr.nii

Flags, defaults and the ``--config`` precedence (a flag given on the command
line > the config file > the parser's default) are the reference's.  Every
command runs on the CUDA card, or raises without one; ``--cpu`` runs it on
the CPU.  On the card the training step is one CUDA graph replayed per step
(``train/steps.py``) and validation runs the graphed ``ResDiffPipeline``.
Checkpoints are the port's own (``utils/checkpoint.py``); the JAX CLI's
Orbax checkpoints are not read.  The reference's other subcommands are not
ported yet and are not registered.

A resumed run takes up the batch sequence where it stopped (the loader runs
from the global batch number) and each step draws from
``step_generator(seed, step)``, so ``--resume`` continues the run bitwise
(on a card, with ``torch.backends.cudnn.deterministic`` set: cuDNN's default
algorithms may sum in another order from run to run).
Each training command ends by logging its throughput to ``metrics.jsonl``:
steps per second (of the whole run, and of the loop after its first step
without validation), the loader thread's time to make a batch, the time
the loop waited for one, and (on the card) the device time of a step.
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
    the loader thread's time to make a batch, the loop's wait for one, and (on a card) each step's device
    time."""

    def __init__(self, device):
        self.device, self.t0, self.wait, self.steps, self.events = device, time.perf_counter(), 0.0, 0, []
        self.first_end, self.excluded = None, 0.0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def next_batch(self, batches):
        t0 = time.perf_counter()
        batch = next(batches)
        self.wait += time.perf_counter() - t0
        return batch

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

    def record(self, loader) -> dict:
        self._sync()
        end = time.perf_counter()
        loop = end - self.first_end - self.excluded if self.first_end is not None else 0.0
        rec = {"steps": self.steps, "steps_per_s": self.steps / (end - self.t0),
               "loop_steps_per_s_after_first": (self.steps - 1) / loop if loop > 0 else 0.0,
               "data_make_ms_per_batch": 1e3 * loader.make_seconds / max(loader.made, 1),
               "data_wait_ms_per_batch": 1e3 * self.wait / max(self.steps, 1)}
        if self.events:
            ms = [s.elapsed_time(e) for s, e in self.events]
            rec.update(step_device_ms=sum(ms) / len(ms), step_device_ms_after_first=sum(ms[1:]) / max(len(ms) - 1, 1))
        return rec


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
        batch = meter.next_batch(batches)
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
    logger.log(i, meter.record(loader), prefix="run_")
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
        batch = meter.next_batch(batches)
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
    logger.log(i, meter.record(loader), prefix="run_")
    mgr.save(i, state, force=True)
    mgr.close()
    return {"state": state, "step": step, "pipeline": pipe}


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
    out = super_resolve_volume(pipe, args.input, args.output, resolution=args.resolution, batch_size=args.batch,
                               num_steps=args.ddim_steps, seed=args.seed, chain_group=chains)
    print(f"wrote {args.output} shape={out.shape}")
    return {"pipeline": pipe, "volume": out}


_COMMANDS = {"train-cnn": _train_cnn, "train-resdiff": _train_resdiff, "build-cache": _build_cache,
             "sr-volume": _sr_volume}


def run(argv=None) -> dict:
    """Parse ``argv`` and run the command; returns what it built (the train state and step, the pipeline)."""
    ap, subparsers = build_parser()
    args = ap.parse_args(argv)
    _apply_config(args, subparsers[args.cmd])
    return _COMMANDS[args.cmd](args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
