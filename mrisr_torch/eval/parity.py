"""Fidelity-parity harness: train the hermetic configs, record metrics (port of ``mrisr_tpu/eval/parity.py``).

The reference's only reproducible fidelity anchor is the Stage-1 CNN on
FastMRI (PSNR 27.92 +/- 3.39 dB, SSIM 0.859, NMSE 0.180, HFEN 1.052:
``ResDif_execution.ipynb`` cell 32's saved output).  The harness produces
evidence, not claims, in the reference's report layout, key for key:

* ``mnist_regression``: the reference's MNIST regression (cell 9), PSNR
  against the bicubic baseline it must beat;
* ``phantom_cnn``: Stage-1 SimpleCNN on synthetic phantoms with the FastMRI
  path's x4 degradation, the four metrics and the bicubic baseline;
* ``phantom_resdiff``: Stage-2 training and a sweep of chain lengths, then
  (at 128^2 and up, exact training) every serving profile against the exact
  one with paired noise: per-image metrics, paired deltas with a 95 % CI and
  the ``within_0p1db`` verdict;
* ``fastmri_cnn``: with a FastMRI patient index, the cell-32 evaluation
  against the published anchor;
* :func:`run_phantom_latent` (``parity-latent``): the latent family trained
  at phantom scale (VAE, base UNet, ControlNet, LoRA and the optional
  adapter, ControlNet+LoRA and rank-sweep legs), every row sampled through
  ``LatentSRPipeline`` against the bicubic input.

Randomness.  The reference draws initial weights, training noise and chain
noise from JAX keys, which the port cannot reproduce.  Each leg seeds torch
with the numbers the reference's keys are made from (``torch.manual_seed(0)``
for the modules JAX initialises from ``PRNGKey(0)``, ``step_generator(seed,
step)`` for each training step, as ``make_resdiff_train_many`` does).  Batch
indices come from the same ``np.random.default_rng`` calls, so they are the
reference's.  The ResDiff chains' starting noise for chain g under seed s is
drawn from ``step_generator(s, g)`` whatever the profile, so every profile
sees the same noise for each (image, seed); a latent row's chain noise for
seed s from ``step_generator(s, 0)``.  For tests, each leg takes ``params=``
(initial weights in the port's layout) and the sampling legs ``noise=`` (the
reference's draws handed over).

Weights reach the pipelines by copying in place (``_load_``), never by
rebinding parameters: a captured CUDA graph keeps the addresses of the
tensors it read and would otherwise replay stale weights without an error.

Run: ``python -m mrisr_torch.cli parity --out PARITY.json`` (the card;
``--cpu`` for the CPU).
"""
from __future__ import annotations

import json
import time
from collections.abc import Callable, Mapping
from pathlib import Path

import numpy as np
import torch

from mrisr_torch.data.degrade import simulate_low_res_np
from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion.schedules import resdiff_schedule, sd15_schedule
from mrisr_torch.eval.metrics import compute_mri_metrics, compute_mri_metrics_per_image
from mrisr_torch.models.resdiff_unet import ResDiffUNet
from mrisr_torch.models.simple_cnn import SimpleCNN
from mrisr_torch.pipelines.latent import ChainNoise, LatentSRPipeline
from mrisr_torch.pipelines.resdiff import ResDiffPipeline
from mrisr_torch.train.state import (
    TrainState,
    cosine_decay_schedule,
    create_train_state,
    make_optimizer,
    multi_transform,
)
from mrisr_torch.train.steps import make_cnn_train_many, make_resdiff_train_many, step_generator

REFERENCE_ANCHORS = {
    "fastmri_cnn": {"psnr": 27.9176, "ssim": 0.8590, "nmse": 0.1796, "hfen": 1.0523},
    "source": "ResDif_execution.ipynb cell 32 saved output (SURVEY.md §6)",
}
METRICS = ("psnr", "ssim", "nmse", "hfen")


# ---------------------------------------------------------------------------
# Metrics and statistics
# ---------------------------------------------------------------------------


def _nchw_unit(x, device) -> torch.Tensor:
    """NHWC numpy or tensor -> float32 NCHW on ``device``, clipped to [0, 1]."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(device, torch.float32).clamp(0, 1).permute(0, 3, 1, 2)


def _metrics(sr, hr, device: str | torch.device = "cpu") -> dict:
    """PSNR, SSIM, NMSE and HFEN over the batch (NHWC inputs clipped to [0, 1]), on ``device``."""
    p, s, n, h = compute_mri_metrics(_nchw_unit(sr, device), _nchw_unit(hr, device))
    return {"psnr": float(p), "ssim": float(s), "nmse": float(n), "hfen": float(h)}


def _metrics_per_image(sr, hr, device: str | torch.device = "cpu") -> dict:
    """Per-image metric lists (floats), NHWC inputs."""
    vals = compute_mri_metrics_per_image(_nchw_unit(sr, device), _nchw_unit(hr, device))
    return {m: v.double().cpu().numpy().astype(float).tolist() for m, v in zip(METRICS, vals)}


def _paired_delta_stats(exact, other, n_seeds: int = 1) -> dict:
    """Paired per-sample ``delta = exact - other`` statistics with a 95 % t-CI (positive: ``other`` worse).

    With ``n_seeds > 1`` the flat arrays are seed-major stacks of ``n_seeds``
    sampler-seed replicates of one image set; a ``clustered_by_image`` block
    then averages the replicates per image first and takes the CI over the
    ``n / n_seeds`` independent images (the conservative interval).
    """
    from scipy import stats

    def _tstats(delta: np.ndarray) -> dict:
        n = delta.size
        mean = float(delta.mean())
        sd = float(delta.std(ddof=1)) if n > 1 else 0.0
        half = float(stats.t.ppf(0.975, n - 1) * sd / np.sqrt(n)) if n > 1 else 0.0
        return {"n": int(n), "mean": mean, "std": sd, "ci95": [mean - half, mean + half],
                "max": float(delta.max()), "min": float(delta.min())}

    delta = np.asarray(exact, np.float64) - np.asarray(other, np.float64)
    out = _tstats(delta)
    if n_seeds > 1 and delta.size % n_seeds == 0:
        out["clustered_by_image"] = _tstats(delta.reshape(n_seeds, delta.size // n_seeds).mean(axis=0))
    return out


# ---------------------------------------------------------------------------
# Synthetic phantoms
# ---------------------------------------------------------------------------


def _phantom_batches(n: int, res: int, seed0: int = 0, textured: bool = True, degrade_scale: float = 4.0,
                     texture_mode: str = "recoverable"):
    """``n`` synthetic (LR, HR) pairs ``[n, res, res, 1]`` float32, image i from ``default_rng(seed0 + i)``.

    ``textured=False``: six smooth Gaussian blobs.  ``textured=True`` adds
    texture gated to the tissue; ``texture_mode="legacy"`` a 0.08-0.25
    cycles/px band that the degradation destroys, ``"recoverable"`` a
    0.04-0.11 band it only attenuates, a ridge texture locked to the smooth
    anatomy and ~2 px vessel lines.  The LR is ``simulate_low_res_np`` (blur
    sigma 0.5 * scale, bicubic down and up) without PIL.
    """
    from scipy.ndimage import gaussian_filter

    hrs, lrs = [], []
    for i in range(n):
        rng = np.random.default_rng(seed0 + i)
        yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
        img = np.zeros((res, res), np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(res * 0.2, res * 0.8, 2)
            a, b = rng.uniform(res * 0.05, res * 0.3, 2)
            img += rng.uniform(0.2, 1.0) * np.exp(-(((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2))
        if textured:
            legacy = texture_mode == "legacy"
            gate = np.clip(img / 0.3, 0.0, 1.0)
            lo, hi, amp = (0.08, 0.25, 0.15) if legacy else (0.04, 0.11, 0.12)
            f = np.fft.fft2(rng.standard_normal((res, res)).astype(np.float32))
            fy = np.fft.fftfreq(res)[:, None]
            fx = np.fft.fftfreq(res)[None, :]
            r = np.sqrt(fy**2 + fx**2)
            band = ((r > lo) & (r < hi)).astype(np.float32)
            tex = np.fft.ifft2(f * band).real.astype(np.float32)
            tex /= max(float(tex.std()), 1e-6)
            img += amp * tex * gate
            if not legacy:
                phi = gaussian_filter(img, sigma=res * 0.02)
                img += 0.12 * np.sin(2.0 * np.pi * 6.0 * phi) * gate
            for _ in range(4 if legacy else 3):
                t = np.linspace(0, 1, res * 4, dtype=np.float32)
                x0, y0 = rng.uniform(0.1 * res, 0.9 * res, 2)
                ang = rng.uniform(0, 2 * np.pi)
                amp_w = rng.uniform(0.05, 0.2) * res
                freq = rng.uniform(1.0, 3.0)
                length = rng.uniform(0.3, 0.8) * res
                wave = amp_w * np.sin(2 * np.pi * freq * t)
                cxs = x0 + t * length * np.cos(ang) + wave * np.sin(ang)
                cys = y0 + t * length * np.sin(ang) - wave * np.cos(ang)
                ix = np.clip(cxs.astype(int), 0, res - 1)
                iy = np.clip(cys.astype(int), 0, res - 1)
                v = np.zeros_like(img)
                v[iy, ix] = 1.0
                if not legacy:
                    v = np.minimum(gaussian_filter(v, sigma=0.8) * 2.5, 1.0)
                img += rng.uniform(0.3, 0.6) * v
        img = np.clip(img, 0, 1)
        hrs.append(img[..., None])
        lrs.append(simulate_low_res_np(img, degrade_scale)[..., None])
    return np.stack(lrs), np.stack(hrs)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def _load_(module: torch.nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Copy ``params`` (every parameter of ``module``, by name) into the module's own tensors."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameters differ: {sorted(set(own) ^ set(params))[:8]}")
    torch._foreach_copy_([own[k] for k in params], [params[k].to(own[k].device, own[k].dtype) for k in params])


def _clone(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


# ---------------------------------------------------------------------------
# MNIST
# ---------------------------------------------------------------------------


def run_mnist(steps: int = 300, batch: int = 64, device: str | torch.device = "cuda",
              params: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The reference's MNIST regression (Adam 1e-3, the synthetic digits), then the first 64 digits against
    the bicubic upsampling of their LR."""
    from mrisr_torch.data.datasets import MNISTSRDataset
    from mrisr_torch.data.loader import Loader
    from mrisr_torch.models.mnist_unet import MNISTUNet
    from mrisr_torch.ops.resize import interpolate_like_torch
    from mrisr_torch.train.steps import make_mnist_regression_step

    dev = resolve_device(device)
    ds = MNISTSRDataset(None)
    loader = Loader(ds, batch_size=batch, shuffle=True, seed=0)
    torch.manual_seed(0)
    model = MNISTUNet(num_classes=10, device=dev)
    if params is not None:
        _load_(model, params)
    state = create_train_state(model, make_optimizer(1e-3), device=dev)
    step = make_mnist_regression_step(model, dev)

    def upsample(lr: torch.Tensor) -> torch.Tensor:
        return _nhwc(interpolate_like_torch(_nchw(lr.to(dev)), (28, 28)))

    i = 0
    while i < steps:
        for b in loader:
            if i >= steps:
                break
            hr = _tensor(b["hr"], dev)
            state, _ = step(state, {"hr": hr, "lr_up": upsample(_tensor(b["lr"], dev))})
            i += 1

    val = [ds[j] for j in range(64)]
    hr = np.stack([v["hr"] for v in val])
    lr_up = upsample(_tensor(np.stack([v["lr"] for v in val]), dev))
    _load_(model, state.params)
    model.eval()
    with torch.no_grad():
        pred = _nhwc(model(_nchw(lr_up)))
    return {"steps": steps, "model": _metrics(pred, hr, dev), "bicubic_baseline": _metrics(lr_up, hr, dev)}


# ---------------------------------------------------------------------------
# Phantom stage 1
# ---------------------------------------------------------------------------


def run_phantom_cnn(steps: int = 400, res: int = 64, batch: int = 8, n_train: int = 64, textured: bool = True,
                    degrade_scale: float = 4.0, texture_mode: str = "recoverable",
                    device: str | torch.device = "cuda", params: Mapping[str, torch.Tensor] | None = None) -> dict:
    """Stage-1 SimpleCNN (Adam 1e-4) on ``n_train`` phantoms, in chunks of at most 1000 steps (the steps are
    cut to a whole number of chunks, as in the reference), evaluated on 32 held-out phantoms.  The result's
    ``cnn_params`` (the trained weights by name) go to :func:`run_phantom_resdiff` and not into the JSON."""
    dev = resolve_device(device)
    torch.manual_seed(0)
    cnn = SimpleCNN(device=dev)
    if params is not None:
        _load_(cnn, params)
    state = create_train_state(cnn, make_optimizer(1e-4), device=dev)
    lr_all, hr_all = _phantom_batches(n_train, res, textured=textured, degrade_scale=degrade_scale,
                                      texture_mode=texture_mode)
    many = make_cnn_train_many(cnn, device=dev)
    lr_dev, hr_dev = _tensor(lr_all, dev), _tensor(hr_all, dev)
    chunk = min(1000, steps)
    steps = (steps // chunk) * chunk
    for s0 in range(0, steps, chunk):
        idx = np.stack([np.random.default_rng(i).integers(0, len(lr_all), batch) for i in range(s0, s0 + chunk)])
        state, _ = many(state, lr_dev, hr_dev, idx)

    lr_te, hr_te = _phantom_batches(32, res, seed0=1000, textured=textured, degrade_scale=degrade_scale,
                                    texture_mode=texture_mode)
    _load_(cnn, state.params)
    cnn.eval()
    with torch.no_grad():
        pred = _nhwc(cnn(_nchw(_tensor(lr_te, dev))))
    return {"steps": steps, "model": _metrics(pred, hr_te, dev), "bicubic_baseline": _metrics(lr_te, hr_te, dev),
            "cnn_params": _clone(state.params)}


# ---------------------------------------------------------------------------
# Phantom stage 2
# ---------------------------------------------------------------------------


def _save_ckpt(path: str | Path, state: TrainState) -> None:
    """``state.state_dict()`` written atomically: a temporary file, then a rename."""
    tmp = Path(str(path) + ".tmp")
    torch.save(state.state_dict(), tmp)
    tmp.replace(path)


def _resume(path: str | Path, state: TrainState, unet: ResDiffUNet) -> int:
    """Load a ``--ckpt`` file into ``state`` in place and return its step: the port's (``torch.save`` of
    ``TrainState.state_dict()``) or the reference's Flax msgpack (parameters, EMA, Adam's moments and count,
    step; ``weights.load_flax_train_checkpoint``)."""
    with open(path, "rb") as f:
        port = f.read(4) == b"PK\x03\x04"  # torch.save writes a zip archive
    if port:
        state.load_state_dict_(torch.load(path, map_location="cpu", weights_only=True))
    else:
        from mrisr_torch.weights import load_flax_train_checkpoint

        load_flax_train_checkpoint(state, unet, path)
    return int(state.step)


def train_phantom_resdiff(unet: ResDiffUNet, sched, state: TrainState, sr_all: torch.Tensor, hr_all: torch.Tensor,
                          batch: int, steps: int, chunk: int, eval_every: int = 0,
                          ckpt_path: str | None = None, resume_ckpt: str | None = None,
                          evaluate: Callable[[int, torch.Tensor, int], None] | None = None,
                          seed: int = 1) -> tuple[TrainState, int]:
    """Stage-2 training over the device-resident stage-1 outputs ``sr_all`` and targets ``hr_all``.

    Steps run in chunks of ``chunk``; ``steps`` is cut to a whole number of
    chunks (0 below one chunk).  Step i trains on ``default_rng(10_000 +
    i).integers(0, n, batch)`` with ``step_generator(seed, i)``.  After a
    chunk that ends on a multiple of ``eval_every`` (or the last),
    ``evaluate(done, last_loss, steps)`` runs and the state is written to
    ``ckpt_path``.  A ``resume_ckpt`` that exists is loaded into ``state`` in
    place first, and training goes on from its step.  -> (state, steps).
    """
    start = 0
    if resume_ckpt and Path(resume_ckpt).exists():
        start = _resume(resume_ckpt, state, unet)
        print(f"[resdiff] resumed from {resume_ckpt} at step {start}", flush=True)
    many = make_resdiff_train_many(unet, sched, device=sr_all.device)
    if eval_every and eval_every % chunk:
        raise ValueError(f"eval_every ({eval_every}) must be a multiple of the dispatch chunk ({chunk})")
    steps = (steps // chunk) * chunk if steps >= chunk else 0
    n = sr_all.shape[0]
    for s0 in range(start, steps, chunk):
        idx = np.stack([np.random.default_rng(10_000 + i).integers(0, n, batch) for i in range(s0, s0 + chunk)])
        state, losses = many(state, sr_all, hr_all, idx, range(s0, s0 + chunk), seed)
        done = s0 + chunk
        if eval_every and (done % eval_every == 0 or done == steps):
            if evaluate is not None:
                evaluate(done, losses[-1], steps)
            if ckpt_path:
                _save_ckpt(ckpt_path, state)
    return state, steps


def sample_set(pipe: ResDiffPipeline, unet_params: Mapping[str, torch.Tensor], lr: torch.Tensor, batch: int,
               seed: int, num_steps: int, noise: Callable[[int, int, tuple], torch.Tensor] | None = None):
    """SR of the set ``lr`` ``[n, H, W, 1]`` through ``pipe`` with ``unet_params`` copied into its UNet in place
    (a graph it captured stays valid): G chains of ``batch`` images when ``n`` is a multiple of ``batch``
    above it, else one chain.  Chain g starts from ``noise(seed, g, shape)``, by default drawn from
    ``step_generator(seed, g)``, so every profile sees the same noise for each (image, seed)."""
    _load_(pipe.unet, unet_params)
    n = lr.shape[0]
    groups = n // batch if n > batch and n % batch == 0 else 1
    outs = []
    for g, lr_g in enumerate(lr.reshape(groups, -1, *lr.shape[1:])):
        shape = tuple(lr_g.shape)
        x_T = noise(seed, g, shape) if noise is not None else torch.randn(
            shape, generator=step_generator(seed, g, lr.device), device=lr.device)
        outs.append(pipe.super_resolve(lr_g, x_T=x_T.to(lr.device), num_steps=num_steps))
    return torch.cat(outs)


PROFILES_128 = [("kv_pool_2", 2, 4096), ("kv_pool_4", 4, 4096), ("kv_pool_8", 8, 4096)]
PROFILES_256 = [("selective_4", 4, 8192), ("selective_8", 8, 8192)]


def run_phantom_resdiff(
    cnn_result: dict,
    steps: int = 300,
    res: int = 64,
    batch: int = 8,
    sample_steps: tuple = (10, 50, 250, 1000),
    n_train: int = 64,
    lr_schedule: str = "constant",
    ema_decay: float = 0.99,
    textured: bool = True,
    degrade_scale: float = 4.0,
    ca_kv_pool: int = 0,
    texture_mode: str = "recoverable",
    eval_every: int = 0,
    ckpt_path: str | None = None,
    resume_ckpt: str | None = None,
    inner_channel: int = 16,
    n_test: int = 16,
    sample_seeds: tuple = (2,),
    chunk_steps: int = 0,
    profile_steps: int = 50,
    device: str | torch.device = "cuda",
    params: Mapping[str, torch.Tensor] | None = None,
    noise: Callable[[int, int, tuple], torch.Tensor] | None = None,
) -> dict:
    """Stage-2 training (Adam 2e-4, constant or cosine to 5 %, EMA) and the fidelity evaluation.

    ``n_test`` held-out phantoms x ``len(sample_seeds)`` sampler seeds feed
    the paired per-image statistics.  ``chunk_steps`` is the training chunk
    (0: ``eval_every``, else up to 1000 steps).  ``noise(seed, g, shape)``
    (tests) gives chain g's starting noise ``[B, H, W, 1]`` under ``seed``
    instead of ``step_generator(seed, g)``.
    """
    dev = resolve_device(device)
    cnn = SimpleCNN(device=dev)
    _load_(cnn, cnn_result["cnn_params"])
    cnn.eval()
    torch.manual_seed(1)
    unet = ResDiffUNet(image_size=res, inner_channel=inner_channel, norm_groups=8, ca_kv_pool=ca_kv_pool, device=dev)
    if params is not None:
        _load_(unet, params)
    sched = resdiff_schedule(1000)
    lr = cosine_decay_schedule(2e-4, max(steps, 1), alpha=0.05) if lr_schedule == "cosine" else 2e-4
    state = create_train_state(unet, make_optimizer(lr), ema_decay=ema_decay, device=dev)

    lr_all, hr_all = _phantom_batches(n_train, res, textured=textured, degrade_scale=degrade_scale,
                                      texture_mode=texture_mode)
    lr_te, hr_te = _phantom_batches(n_test, res, seed0=1000, textured=textured, degrade_scale=degrade_scale,
                                    texture_mode=texture_mode)
    lr_te_dev = _tensor(lr_te, dev)

    def unet_for(pool: int, min_tokens: int = 4096) -> ResDiffUNet:
        return ResDiffUNet(image_size=res, inner_channel=inner_channel, norm_groups=8, ca_kv_pool=pool,
                           ca_kv_pool_min_tokens=min_tokens, device=dev)

    # The serving pipeline of the trained profile; the EMA weights are copied into its own UNet.
    pipe = ResDiffPipeline(cnn, unet_for(ca_kv_pool), sched, device=dev)

    def evaluate(done, loss, total):
        _load_(pipe.unet, state.ema_params)
        out = pipe.super_resolve(lr_te_dev[:8], step_generator(2, 0, dev), num_steps=50)
        mm = _metrics(out, hr_te[:8], dev)
        print(f"[resdiff {done}/{total}] loss={float(loss):.5f} 50-step psnr={mm['psnr']:.2f} "
              f"ssim={mm['ssim']:.4f}", flush=True)

    with torch.no_grad():
        sr_dev = _nhwc(cnn(_nchw(_tensor(lr_all, dev))))
    chunk = chunk_steps or (eval_every if eval_every else min(1000, max(steps, 1)))
    state, steps = train_phantom_resdiff(unet, sched, state, sr_dev, _tensor(hr_all, dev), batch, steps, chunk,
                                         eval_every, ckpt_path, resume_ckpt, evaluate)
    ema = state.ema_params

    def _sample(p: ResDiffPipeline, seed: int, nsteps: int) -> torch.Tensor:
        return sample_set(p, ema, lr_te_dev, batch, seed, nsteps, noise)

    seed0 = int(sample_seeds[0])
    by_steps = {str(k): _metrics(_sample(pipe, seed0, int(k)), hr_te, dev) for k in sample_steps}
    best = max(by_steps.values(), key=lambda m: m["psnr"])
    with torch.no_grad():
        stage1 = _nhwc(cnn(_nchw(lr_te_dev)))
    report = {
        "steps": steps,
        "sample_steps": list(sample_steps),
        "n_test": n_test,
        "sample_seeds": [int(s) for s in sample_seeds],
        "model": by_steps.get("50", best),
        "best_chain": best,
        "by_sample_steps": by_steps,
        "stage1_cnn": _metrics(stage1, hr_te, dev),
        "bicubic_baseline": _metrics(lr_te, hr_te, dev),
    }
    if ca_kv_pool == 0 and res >= 128:
        profiles = PROFILES_128 + (PROFILES_256 if res >= 256 else [])

        def eval_profile(p: ResDiffPipeline) -> dict:
            per_seed = [_metrics_per_image(_sample(p, int(s), profile_steps), hr_te, dev) for s in sample_seeds]
            flat = {m: [v for ps in per_seed for v in ps[m]] for m in METRICS}
            return {"mean": {m: float(np.mean(flat[m])) for m in flat}, "per_image": flat}

        exact_eval = eval_profile(pipe)
        prof_report = {"sample_steps": profile_steps, "exact": exact_eval}
        n_seeds = len(sample_seeds)
        for name, pool, min_tok in profiles:
            p = ResDiffPipeline(cnn, unet_for(pool, min_tok), sched, device=dev)
            ev = eval_profile(p)
            del p
            psnr_stats = _paired_delta_stats(exact_eval["per_image"]["psnr"], ev["per_image"]["psnr"], n_seeds)
            ev["delta_vs_exact"] = {
                "psnr": psnr_stats,
                "ssim": _paired_delta_stats(exact_eval["per_image"]["ssim"], ev["per_image"]["ssim"], n_seeds),
            }
            gate = psnr_stats.get("clustered_by_image", psnr_stats)
            ev["within_0p1db"] = bool(gate["ci95"][1] < 0.1)
            ev["within_0p1db_flat"] = bool(psnr_stats["ci95"][1] < 0.1)
            ev["config"] = {"ca_kv_pool": pool, "ca_kv_pool_min_tokens": min_tok}
            prof_report[name] = ev
            print(f"[parity profile {name}] psnr={ev['mean']['psnr']:.4f} dpsnr={psnr_stats['mean']:+.4f} "
                  f"ci95=({psnr_stats['ci95'][0]:+.4f},{psnr_stats['ci95'][1]:+.4f}) "
                  f"within_0.1dB={ev['within_0p1db']}", flush=True)
        report["profiles_50step"] = prof_report
        report["fast_profiles_50step"] = {str(p): prof_report[f"kv_pool_{p}"]["mean"] for p in (2, 4, 8)}
    return report


# ---------------------------------------------------------------------------
# The latent family at phantom scale
# ---------------------------------------------------------------------------


def run_phantom_latent(
    res: int = 64,
    n_train: int = 256,
    n_test: int = 32,
    batch: int = 8,
    vae_steps: int = 4000,
    base_steps: int = 6000,
    cn_steps: int = 3000,
    lora_steps: int = 3000,
    num_inference_steps: int = 20,
    sample_seeds: tuple = (2, 3),
    degrade_scale: float = 4.0,
    texture_mode: str = "recoverable",
    lora_rank: int = 4,
    chunk_steps: int = 0,
    prediction_type: str = "epsilon",
    vae_width: int = 16,
    unet_width: int = 32,
    adapter_steps: int = 0,
    cn_lora_steps: int = 0,
    lora_ranks: tuple = (),
    extra_sample_steps: tuple = (),
    cache_latents: bool = False,
    vae_chunk_steps: int = 0,
    device: str | torch.device = "cuda",
    params: Mapping[str, Mapping[str, torch.Tensor] | torch.Tensor] | None = None,
    noise: Callable[[int, int, tuple], ChainNoise] | None = None,
) -> dict:
    """The latent path's trained-model fidelity (the reference's ``src/adapters/res_srdiff.py:36-105``) at
    phantom scale.

    1. A small ``AutoencoderKL`` (f=4) trained on the HR and LR phantoms, and
       an empirical scaling factor ``1 / std(encode(HR))`` (the posterior
       mean), which the VAE used for every later step carries;
    2. an ``SDUNet`` base on the res-shift objective;
    3. on the frozen base: a ``ControlNet`` (zero-init outputs: untrained, it
       is the base), a LoRA of ``lora_rank`` and the ``lora_ranks`` sweep;
       with ``cn_lora_steps`` a ControlNet and a LoRA trained jointly, with
       ``adapter_steps`` a zero-init T2I-Adapter.

    Every row is sampled through ``LatentSRPipeline`` over ``n_test`` x
    ``len(sample_seeds)`` with paired noise, and held to the bicubic input.
    ``chunk_steps`` (and ``vae_chunk_steps`` for the VAE) run the steps
    through the ``*_many`` wrappers; ``cache_latents`` trains from the frozen
    VAE's cached posterior moments.  ``params`` (tests) may hold initial
    weights by name for ``vae``, ``unet``, ``controlnet`` and ``adapter`` and
    the ``prompt`` embedding; ``noise(seed, steps, latent shape)`` a row's
    chain noise under ``seed``.
    """
    from mrisr_torch.models.adapter import T2IAdapter
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.lora import apply_lora_delta, init_lora_params
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.train import latent as L

    dev = resolve_device(device)
    params = params or {}
    lr_all, hr_all = _phantom_batches(n_train, res, textured=True, degrade_scale=degrade_scale,
                                      texture_mode=texture_mode)
    lr_te, hr_te = _phantom_batches(n_test, res, seed0=1000, textured=True, degrade_scale=degrade_scale,
                                    texture_mode=texture_mode)
    to_pm1 = lambda a: (a * 2.0 - 1.0).astype(np.float32)  # noqa: E731  (model space [-1, 1], metrics in [0, 1])
    to_unit = lambda t: ((t.float() + 1.0) / 2.0).clamp(0.0, 1.0)  # noqa: E731
    gray = lambda t: t.mean(dim=-1, keepdim=True)  # noqa: E731
    rgb = lambda a: _tensor(a, dev).permute(0, 3, 1, 2).expand(-1, 3, -1, -1).contiguous()  # noqa: E731

    w = vae_width
    vae_cfg = dict(block_out_channels=(w, 2 * w, 4 * w), latent_channels=4)
    torch.manual_seed(0)
    vae = AutoencoderKL(**vae_cfg, device=dev)
    if "vae" in params:
        _load_(vae, params["vae"])
    vstate = create_train_state(vae, make_optimizer(1e-3), device=dev)
    vstep = L.make_vae_train_step(vae, device=dev)
    pool = np.concatenate([to_pm1(hr_all), to_pm1(lr_all)])
    pool_dev = _tensor(pool, dev)
    if chunk_steps > 0:
        done, vchunk = 0, vae_chunk_steps or chunk_steps
        while done < vae_steps:
            k = min(vchunk, vae_steps - done)
            ids = np.arange(done, done + k)
            idx = np.stack([np.random.default_rng(int(s)).integers(0, len(pool), batch) for s in ids])
            vstate, vlosses = L.make_vae_train_many(vstep)(vstate, pool_dev, idx, ids, 0)
            done += k
            print(f"[latent vae {done}/{vae_steps}] rec={float(vlosses[-1, 1]):.5f} "
                  f"kl={float(vlosses[-1, 2]):.2f}", flush=True)
    else:
        for i in range(vae_steps):
            idx = torch.as_tensor(np.random.default_rng(i).integers(0, len(pool), batch), device=dev)
            vstate, vm = vstep(vstate, {"img": pool_dev[idx]}, step_generator(0, i, dev))
            if (i + 1) % max(vae_steps // 4, 1) == 0:
                print(f"[latent vae {i+1}/{vae_steps}] rec={float(vm['rec']):.5f} kl={float(vm['kl']):.2f}",
                      flush=True)
    _load_(vae, vstate.params)
    vae.eval()
    del vstep  # (and its captured graph's memory)

    with torch.no_grad():
        lat_sample = vae.encode(rgb(to_pm1(hr_all[:64]))).cpu().numpy()
    scaling = float(1.0 / max(lat_sample.std(), 1e-6))
    vae_s = AutoencoderKL(**vae_cfg, scaling_factor=scaling, device=dev)
    _load_(vae_s, vstate.params)
    vae_s.eval()

    with torch.no_grad():
        rec_te = _nhwc(vae_s(rgb(to_pm1(hr_te))))
    vae_ceiling = _metrics(gray(to_unit(rec_te)), hr_te, dev)
    print(f"[latent vae] recon ceiling psnr={vae_ceiling['psnr']:.2f}", flush=True)

    f = res // (2 ** (len(vae_cfg["block_out_channels"]) - 1))  # the latents' side
    uw = unet_width
    tower = dict(block_out_channels=(uw, 2 * uw, 2 * uw, 2 * uw), heads=2, context_dim=16)
    torch.manual_seed(1)
    unet = SDUNet(**tower, device=dev)
    cn = ControlNet(**tower, cond_block_channels=(8, 16, 32), device=dev)
    for name, module in (("unet", unet), ("controlnet", cn)):
        if name in params:
            _load_(module, params[name])
    cn_params0 = _clone(dict(cn.named_parameters()))
    sched = sd15_schedule()
    prompt = params["prompt"] if "prompt" in params else torch.randn(
        (1, 7, 16), generator=torch.Generator().manual_seed(42))
    prompt = prompt.to(dev, torch.float32)
    empty = torch.zeros((1, 7, 16), device=dev)
    hr_pm1, lr_pm1 = to_pm1(hr_all), to_pm1(lr_all)
    lr_dev, hr_dev = _tensor(lr_pm1, dev), _tensor(hr_pm1, dev)

    arrays_dev = None
    if cache_latents:
        parts = {k: [] for k in L.CACHED_KEYS}
        with torch.no_grad():
            for s0 in range(0, n_train, 64):
                hm, hv = vae.encode_moments(rgb(hr_pm1[s0 : s0 + 64]))
                lm, lv = vae.encode_moments(rgb(lr_pm1[s0 : s0 + 64]))
                for k_, v_ in zip(parts, (hm, hv, lm, lv)):
                    parts[k_].append(_nhwc(v_))
        arrays_dev = {k: torch.cat(v) for k, v in parts.items()}
        arrays_dev["lr"] = lr_dev  # pixels for the condition branches
        print(f"[latent cache] moments cached for {n_train} pairs ({tuple(arrays_dev['hr_mean'].shape)})",
              flush=True)

    def train_loop(state, step_fn, steps, tag, seed0=0):
        if chunk_steps > 0:
            if cache_latents:
                many = L.make_latent_train_many_cached(step_fn)
                run = lambda st, idx, ids: many(st, arrays_dev, idx, ids, 0)  # noqa: E731
            else:
                many = L.make_latent_train_many(step_fn)
                run = lambda st, idx, ids: many(st, lr_dev, hr_dev, idx, ids, 0)  # noqa: E731
            done = 0
            while done < steps:
                k = min(chunk_steps, steps - done)
                ids = np.arange(seed0 + done, seed0 + done + k)
                idx = np.stack([np.random.default_rng(int(s)).integers(0, n_train, batch) for s in ids])
                state, losses = run(state, idx, ids)
                done += k
                print(f"[latent {tag} {done}/{steps}] loss={float(losses[-1]):.5f}", flush=True)
            return state
        for i in range(steps):
            idx = torch.as_tensor(np.random.default_rng(seed0 + i).integers(0, n_train, batch), device=dev)
            b = ({k: v[idx] for k, v in arrays_dev.items()} if cache_latents
                 else {"hr": hr_dev[idx], "lr": lr_dev[idx]})
            state, m = step_fn(state, b, step_generator(0, seed0 + i, dev))
            if (i + 1) % max(steps // 4, 1) == 0:
                print(f"[latent {tag} {i+1}/{steps}] loss={float(m['loss']):.5f}", flush=True)
        return state

    common = dict(prediction_type=prediction_type, latents_cached=cache_latents, device=dev)
    # 2) the base UNet (the stand-in for SD1.5 pretraining)
    bstate = create_train_state(unet, make_optimizer(2e-4), device=dev)
    bstep = L.make_latent_base_train_step(unet, vae_s, sched, prompt, empty, **common)
    bstate = train_loop(bstate, bstep, base_steps, "base", 10_000)
    _load_(unet, bstate.params)
    base_params = _clone(bstate.params)
    del bstep

    # 3a) ControlNet on the frozen base
    cstate = create_train_state(cn, make_optimizer(2e-4), device=dev)
    cstep = L.make_controlnet_train_step(unet, cn, vae_s, sched, prompt, empty, **common)
    cstate = train_loop(cstate, cstep, cn_steps, "cn", 20_000)
    cn_trained = _clone(cstate.params)
    del cstep, cstate

    # 3b) LoRA on the frozen base: the primary rank, then the sweep
    def merged_params(lora: dict) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            return _clone(apply_lora_delta(unet, lora))

    def train_lora(rank: int, seed0: int, init_seed: int):
        lora0 = init_lora_params(unet, rank=rank, generator=torch.Generator(dev).manual_seed(init_seed))
        lstate = create_train_state(L.lora_params(lora0), make_optimizer(1e-3), device=dev)
        lstep = L.make_lora_train_step(unet, vae_s, sched, prompt, **common)
        lstate = train_loop(lstate, lstep, lora_steps, f"lora_r{rank}", seed0)
        return merged_params(L.lora_tree(lstate.params))

    lora_merged = train_lora(lora_rank, 30_000, 5)
    sweep_merged = {}
    for j, r in enumerate(lora_ranks):
        if int(r) != lora_rank:
            sweep_merged[int(r)] = train_lora(int(r), 70_000 + j * 10_000, 500 + j)

    # 3c) ControlNet + LoRA trained jointly (the reference notebook's configuration)
    cl_unet = cl_cn = None
    if cn_lora_steps > 0:
        _load_(cn, cn_params0)
        lora0 = init_lora_params(unet, rank=lora_rank, generator=torch.Generator(dev).manual_seed(6))
        tx = multi_transform({"cn": make_optimizer(2e-4), "lora": make_optimizer(1e-3)},
                             lambda name: name.split("/", 1)[0])
        clstate = create_train_state(L.cn_lora_params(cn, lora0), tx, device=dev)
        clstep = L.make_cn_lora_train_step(unet, cn, vae_s, sched, prompt, empty_embeds=empty, **common)
        clstate = train_loop(clstate, clstep, cn_lora_steps, "cn_lora", 50_000)
        cl_unet = merged_params(L.lora_tree(clstate.params, "lora/"))
        cl_cn = _clone({k[len("cn/"):]: v for k, v in clstate.params.items() if k.startswith("cn/")})
        del clstep, clstate

    # 3d) T2I-Adapter on the frozen base (zero-init outputs: untrained, it is the base)
    ad = ad_params = None
    if adapter_steps > 0:
        unsh = res // f
        torch.manual_seed(7)
        ad = T2IAdapter(channels=tower["block_out_channels"], num_res_blocks=3, cin=3 * unsh * unsh,
                        unshuffle_factor=unsh, zero_out=True, device=dev)
        if "adapter" in params:
            _load_(ad, params["adapter"])
        astate = create_train_state(ad, make_optimizer(2e-4), device=dev)
        astep = L.make_adapter_train_step(unet, ad, vae_s, sched, prompt, empty, **common)
        astate = train_loop(astate, astep, adapter_steps, "adapter", 40_000)
        ad_params = _clone(astate.params)
        del astep, astate

    pipe = LatentSRPipeline(unet, cn, vae_s, sched, prompt, prediction_type=prediction_type, device=dev)
    pipe_ad = (LatentSRPipeline(unet, None, vae_s, sched, prompt, prediction_type=prediction_type, adapter=ad,
                                device=dev) if ad is not None else None)
    lr_te_dev = _tensor(to_pm1(lr_te), dev)
    n_seeds = len(sample_seeds)

    def sample_rows(unet_p, side_p, p=None, nsteps=None) -> dict:
        """Per-image metrics over n_test x len(sample_seeds), the chain noise paired by seed across rows."""
        p = p or pipe
        nsteps = num_inference_steps if nsteps is None else nsteps
        _load_(p.unet, unet_p)
        _load_(p.adapter if p.adapter is not None else p.controlnet, side_p)
        shape = p.latent_shape(lr_te_dev)
        per_seed = []
        for s in sample_seeds:
            chain_noise = noise(int(s), nsteps, shape) if noise is not None else ChainNoise.draw(
                shape, nsteps, step_generator(int(s), 0, dev), dev)
            out = p.super_resolve(lr_te_dev, num_steps=nsteps, noise=chain_noise)
            per_seed.append(_metrics_per_image(gray(to_unit(out)), hr_te, dev))
        flat = {m: [v for ps in per_seed for v in ps[m]] for m in METRICS}
        return {"mean": {m: float(np.mean(flat[m])) for m in flat}, "per_image": flat}

    rows = {
        "base_unet": sample_rows(base_params, cn_params0),
        "controlnet": sample_rows(base_params, cn_trained),
        "lora": sample_rows(lora_merged, cn_params0),
    }
    for r, merged in sweep_merged.items():
        rows[f"lora_r{r}"] = sample_rows(merged, cn_params0)
    if cl_unet is not None:
        rows["cn_lora"] = sample_rows(cl_unet, cl_cn)
    if ad_params is not None:
        rows["adapter"] = sample_rows(base_params, ad_params, p=pipe_ad)

    bicubic_flat = _metrics_per_image(lr_te, hr_te, dev)
    bicubic_rep = {m: bicubic_flat[m] * n_seeds for m in bicubic_flat}

    def attach_bicubic_delta(row: dict) -> dict:
        # delta = model - bicubic here (positive: the model is better); the verdict takes the image-clustered
        # interval (seed replicates of one image are correlated).
        psnr_stats = _paired_delta_stats(row["per_image"]["psnr"], bicubic_rep["psnr"], n_seeds=n_seeds)
        row["delta_vs_bicubic_psnr"] = psnr_stats
        gate = psnr_stats.get("clustered_by_image", psnr_stats)
        row["beats_bicubic"] = bool(gate["ci95"][0] > 0.0)
        row["beats_bicubic_flat"] = bool(psnr_stats["ci95"][0] > 0.0)
        return psnr_stats

    for name, row in rows.items():
        psnr_stats = attach_bicubic_delta(row)
        gate = psnr_stats.get("clustered_by_image", psnr_stats)
        print(f"[latent row {name}] psnr={row['mean']['psnr']:.3f} dpsnr_vs_bicubic={psnr_stats['mean']:+.3f} "
              f"ci95_clustered=({gate['ci95'][0]:+.3f},{gate['ci95'][1]:+.3f})", flush=True)

    extra = {"controlnet": lambda k: sample_rows(base_params, cn_trained, nsteps=k),
             "lora": lambda k: sample_rows(lora_merged, cn_params0, nsteps=k),
             "cn_lora": lambda k: sample_rows(cl_unet, cl_cn, nsteps=k),
             "adapter": lambda k: sample_rows(base_params, ad_params, p=pipe_ad, nsteps=k)}
    for k in extra_sample_steps:
        k = int(k)
        for name, run in extra.items():
            if name not in rows:
                continue
            r = run(k)
            attach_bicubic_delta(r)
            rows[name][f"steps_{k}"] = r
            print(f"[latent row {name} @{k} steps] psnr={r['mean']['psnr']:.3f} "
                  f"beats_bicubic={r['beats_bicubic']}", flush=True)

    cn_vs_base = _paired_delta_stats(rows["controlnet"]["per_image"]["psnr"], rows["base_unet"]["per_image"]["psnr"],
                                     n_seeds=n_seeds)
    return {
        "reference_entry_point": "src/adapters/res_srdiff.py:36-105",
        "config": {
            "res": res, "n_train": n_train, "n_test": n_test,
            "vae": {**vae_cfg, "f": res // f, "scaling_factor": scaling},
            "unet_channels": [uw, 2 * uw, 2 * uw, 2 * uw],
            "steps": {"vae": vae_steps, "base": base_steps, "cn": cn_steps, "lora": lora_steps,
                      "adapter": adapter_steps, "cn_lora": cn_lora_steps},
            "num_inference_steps": num_inference_steps,
            "extra_sample_steps": [int(s) for s in extra_sample_steps],
            "sample_seeds": [int(s) for s in sample_seeds],
            "lora_rank": lora_rank,
            "lora_ranks": [int(r) for r in lora_ranks],
            "degrade_scale": degrade_scale, "texture_mode": texture_mode,
            "chunk_steps": chunk_steps, "prediction_type": prediction_type,
            "cache_latents": cache_latents, "vae_chunk_steps": vae_chunk_steps,
        },
        "bicubic_baseline": _metrics(lr_te, hr_te, dev),
        "vae_recon_ceiling": vae_ceiling,
        **rows,
        "controlnet_minus_base_psnr": cn_vs_base,
    }


# ---------------------------------------------------------------------------
# FastMRI and the whole harness
# ---------------------------------------------------------------------------


def run_fastmri_cnn(index_json: str, steps: int = 2000, res: int = 256, batch: int = 8,
                    device: str | torch.device = "cuda", params: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The reference's CNN-stage evaluation on real FastMRI data (cell 29's training, cell 32's evaluation;
    the anchor in ``REFERENCE_ANCHORS``): mean of the per-slice metrics over the test split."""
    from mrisr_torch.data.datasets import FastMRISliceDataset
    from mrisr_torch.data.loader import Loader
    from mrisr_torch.train.steps import make_cnn_train_step

    dev = resolve_device(device)
    train = FastMRISliceDataset(json_path=index_json, mode="train", target_size=(res, res))
    test = FastMRISliceDataset(json_path=index_json, mode="test", target_size=(res, res))
    loader = Loader(train, batch_size=batch, shuffle=True, seed=42)
    torch.manual_seed(0)
    cnn = SimpleCNN(device=dev)
    if params is not None:
        _load_(cnn, params)
    state = create_train_state(cnn, make_optimizer(1e-4), device=dev)
    step = make_cnn_train_step(cnn, device=dev)
    i = 0
    while i < steps:
        for b in loader:
            if i >= steps:
                break
            state, _ = step(state, {"lr": _tensor(b["lr"], dev), "hr": _tensor(b["hr"], dev)})
            i += 1
    _load_(cnn, state.params)
    cnn.eval()
    sums, n = None, 0
    with torch.no_grad():
        for j in range(len(test)):
            s = test[j]
            pred = _nhwc(cnn(_nchw(_tensor(s["lr"][None], dev))))
            m = _metrics(pred, np.asarray(s["hr"])[None], dev)
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            n += 1
    result = {k: v / n for k, v in sums.items()}
    return {"steps": steps, "n_test": n, "model": result, "anchor": REFERENCE_ANCHORS["fastmri_cnn"]}


def run_parity(
    out_path: str | Path,
    mnist_steps: int = 300,
    phantom_steps: int = 400,
    resdiff_steps: int = 300,
    res: int = 64,
    index_json: str | None = None,
    n_train: int = 64,
    lr_schedule: str = "constant",
    batch: int = 8,
    textured: bool = True,
    degrade_scale: float = 4.0,
    ca_kv_pool: int = 0,
    skip_mnist: bool = False,
    texture_mode: str = "recoverable",
    eval_every: int = 0,
    ckpt_path: str | None = None,
    resume_ckpt: str | None = None,
    inner_channel: int = 16,
    ema_decay: float = 0.99,
    n_test: int = 16,
    sample_seeds: tuple = (2,),
    chunk_steps: int = 0,
    sample_steps: tuple = (10, 50, 250, 1000),
    device: str | torch.device = "cuda",
) -> dict:
    """The MNIST leg, stage 1, stage 2 and (with ``index_json``) the FastMRI anchor; the report is written to
    ``out_path`` as JSON and returned."""
    t0 = time.time()
    report: dict = {"anchors": REFERENCE_ANCHORS}
    if not skip_mnist:
        report["mnist_regression"] = run_mnist(mnist_steps, device=device)
    cnn_res = run_phantom_cnn(phantom_steps, res, batch=batch, n_train=n_train, textured=textured,
                              degrade_scale=degrade_scale, texture_mode=texture_mode, device=device)
    report["phantom_cnn"] = {k: v for k, v in cnn_res.items() if k != "cnn_params"}
    print(f"[parity] stage-1 CNN: psnr={cnn_res['model']['psnr']:.2f} ssim={cnn_res['model']['ssim']:.4f} | "
          f"bicubic psnr={cnn_res['bicubic_baseline']['psnr']:.2f}", flush=True)
    report["phantom_resdiff"] = run_phantom_resdiff(
        cnn_res, resdiff_steps, res, batch=batch, n_train=n_train, lr_schedule=lr_schedule, textured=textured,
        degrade_scale=degrade_scale, ca_kv_pool=ca_kv_pool, texture_mode=texture_mode, eval_every=eval_every,
        ckpt_path=ckpt_path, resume_ckpt=resume_ckpt, inner_channel=inner_channel, ema_decay=ema_decay,
        n_test=n_test, sample_seeds=sample_seeds, chunk_steps=chunk_steps, sample_steps=sample_steps,
        device=device)
    report["config"] = {
        "n_train": n_train, "lr_schedule": lr_schedule, "res": res, "batch": batch,
        "textured": textured, "degrade_scale": degrade_scale,
        "ca_kv_pool": ca_kv_pool, "texture_mode": texture_mode,
        "inner_channel": inner_channel, "ema_decay": ema_decay,
        "n_test": n_test, "sample_seeds": [int(s) for s in sample_seeds],
        "chunk_steps": chunk_steps,
    }
    if index_json:
        report["fastmri_cnn"] = run_fastmri_cnn(index_json, device=device)
    report["elapsed_sec"] = round(time.time() - t0, 1)
    Path(out_path).write_text(json.dumps(report, indent=2))
    return report
