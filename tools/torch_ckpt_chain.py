"""The port's 50-step chain on the trained checkpoint, held to the JAX package's, on the CPU.

Loads the EMA UNet of ``ckpt_256_r3.msgpack`` (60k steps at 256², inner 32,
8 norm groups: the configuration of the parity run that trained it) into
both packages: JAX through flax, the port through its own msgpack reader.
Two held-out phantoms (``mrisr_tpu/eval/parity.py::_phantom_batches(2, 256,
seed0=1000)``) are the images.  The chain's condition is the LR phantom
itself: the stage-1 CNN of that run was never saved, so both sides take the
same stored condition and no CNN (the port's pipeline runs a SimpleCNN with
zero weights, which is the identity).  The starting noise is a numpy draw.

Both packages run the trailing-spaced 50-step DDIM chain in fp32 in the
exact (``ca_kv_pool=0``) and the fast (``ca_kv_pool=8``) profile; the JAX
side also runs the same scan body with its trajectory kept, for the per-step
max-abs delta.  Writes:

* ``PARITY_TORCH_CKPT_ref.npz``: ``hr``, ``cond``, ``x_T``, JAX's fp32
  ``eps`` of one exact-profile forward (the chain's first step: [cond, x_T]
  at noise level ``eps_gamma``) and JAX's final chain images
  ``final_exact`` / ``final_fast`` (cond + residual, ``[2, 256, 256, 1]``),
  and those of its bf16 serving chains (``final_exact_bf16``,
  ``final_fast_bf16``: parameters, condition and noise cast to bf16, as
  ``bench.py`` serves);
* ``PARITY_TORCH_CKPT.json``: per-image PSNR against HR (images and HR
  clipped to [0, 1]) for JAX and the port per profile, their absolute
  deltas against the bar of 0.01 dB, the max-abs image delta per step, the
  JAX bf16 chains' PSNR (no bar: what bf16 serving costs the reference), and
  the fast - exact PSNR delta beside ``PARITY_r07_256.json``'s interval (for
  information: n = 2).

CPU only, about twenty minutes.  Run from the repository root::

    python tools/torch_ckpt_chain.py
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "ckpt_256_r3.msgpack"
UNET = dict(image_size=256, inner_channel=32, norm_groups=8)
PROFILES = {"exact": 0, "fast": 8}
BAR_DB = 0.01
SEED0, X_T_SEED = 1000, 123
FAST_MINUS_EXACT_CI95 = (0.046, 0.067)  # PARITY_r07_256.json profiles_50step kv_pool_8, n = 128 pairs


def inputs(images: int = 2, res: int = 256):
    """(hr, cond, x_T), each ``[images, res, res, 1]`` float32."""
    from mrisr_tpu.eval.parity import _phantom_batches

    lr, hr = _phantom_batches(images, res, seed0=SEED0)
    cond = np.asarray(lr, np.float32)
    x_T = np.random.default_rng(X_T_SEED).standard_normal(cond.shape).astype(np.float32)
    return np.asarray(hr, np.float32), cond, x_T


def psnr_per_image(final: np.ndarray, hr: np.ndarray) -> list[float]:
    """Per-image PSNR (the port's metrics, fp32 on the CPU) of ``[B, H, W, 1]`` images clipped to [0, 1]."""
    import torch

    from mrisr_torch.eval.metrics import compute_mri_metrics_per_image

    nchw = lambda a: torch.from_numpy(np.clip(a, 0, 1).transpose(0, 3, 1, 2).copy())  # noqa: E731
    return [float(v) for v in compute_mri_metrics_per_image(nchw(final), nchw(hr))[0]]


def jax_chain(params, cond, x_T, steps, kv_pool, dtype="float32", traced=True):
    """JAX's production chain (``sr3_ancestral_sample``) in ``dtype`` (the parameters, condition and
    noise cast to it, as ``bench.py`` casts them): the final image (cond + residual, as float32) and, when
    ``traced``, the same scan body's trajectory."""
    import jax
    import jax.numpy as jnp

    from mrisr_tpu.diffusion import ddim as ddim_mod
    from mrisr_tpu.diffusion.schedules import resdiff_schedule, spaced_timesteps
    from mrisr_tpu.models.resdiff_unet import ResDiffUNet
    from mrisr_tpu.pipelines.sampler import _pairs, sr3_ancestral_sample

    unet = ResDiffUNet(**UNET, ca_kv_pool=kv_pool)
    sched = resdiff_schedule(1000)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    cond_j, x_j = jnp.asarray(cond, dtype), jnp.asarray(x_T, dtype)
    static = unet.apply(params, cond_j, method="compute_static")

    def eps_fn(x_t, gamma):
        return unet.apply(params, jnp.concatenate([cond_j, x_t], axis=-1), gamma, static=static)

    final = jax.jit(lambda x: sr3_ancestral_sample(sched, eps_fn, x, jax.random.PRNGKey(0), num_steps=steps))(x_j)
    final = np.asarray((cond_j + final).astype(jnp.float32))
    if not traced:
        return final, None
    b = cond.shape[0]

    def trajectory(x):
        def body(x, tt):
            t, tp = tt
            tb, tpb = jnp.full((b,), t, jnp.int32), jnp.full((b,), tp, jnp.int32)
            x = ddim_mod.ddim_step(sched, x, tb, tpb, eps_fn(x, sched.sqrt_alphas_cumprod[tb]), None, 0.0, True)
            return x, x

        return jax.lax.scan(body, x, _pairs(spaced_timesteps(1000, steps, "trailing")))[1]

    return final, np.asarray(jax.jit(trajectory)(x_j))


def jax_eps(params, eps_in, gamma):
    """JAX's fp32 eps of one exact-profile forward."""
    import jax.numpy as jnp

    from mrisr_tpu.models.resdiff_unet import ResDiffUNet

    return np.asarray(ResDiffUNet(**UNET).apply(params, jnp.asarray(eps_in), jnp.asarray(gamma)))


def port_pipeline(kv_pool, device="cpu", ckpt=CKPT):
    """The port's fp32 ResDiffPipeline on the checkpoint's EMA, stage 1 the identity."""
    import torch

    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline
    from mrisr_torch.weights import load_flax_checkpoint

    unet = ResDiffUNet(**UNET, ca_kv_pool=kv_pool, device=device)
    load_flax_checkpoint(unet, ckpt)
    cnn = SimpleCNN(device=device)
    with torch.no_grad():
        for p in cnn.parameters():
            p.zero_()
    return ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device=device)


def port_chain(pipe, cond, x_T, steps):
    """The port's chain through ``super_resolve`` and its trajectory (the x_t each step's UNet saw)."""
    import torch

    seen = []
    hook = pipe.unet.register_forward_pre_hook(lambda m, args: seen.append(args[0][:, 1:2].clone()))
    try:
        final = pipe.super_resolve(torch.from_numpy(cond), x_T=torch.from_numpy(x_T), num_steps=steps).numpy()
    finally:
        hook.remove()
    traj = [s.permute(0, 2, 3, 1).numpy() for s in seen[1:]] + [final - cond]
    return final, traj


def run(steps: int = 50, images: int = 2, log=lambda msg: print(msg, flush=True)):
    """The arrays of the npz and the report of the json."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from flax import serialization

    from mrisr_tpu.diffusion.schedules import resdiff_schedule, spaced_timesteps

    t0 = time.time()
    params = serialization.msgpack_restore(CKPT.read_bytes())["ema"]
    hr, cond, x_T = inputs(images)
    t_first = int(spaced_timesteps(1000, steps, "trailing")[0])
    gamma = np.asarray(resdiff_schedule(1000).sqrt_alphas_cumprod)[[t_first] * images].astype(np.float32)
    arrays = {"hr": hr, "cond": cond, "x_T": x_T, "eps_gamma": gamma,
              "eps": jax_eps(params, np.concatenate([cond, x_T], axis=-1), gamma)}
    report = {"checkpoint": CKPT.name, "unet": UNET, "steps": steps, "images": images, "dtype": "float32",
              "device": "cpu", "cond": "the LR phantom itself (no stage-1 CNN on either side)",
              "phantoms": f"_phantom_batches({images}, 256, seed0={SEED0})", "x_T_seed": X_T_SEED,
              "bar_db": BAR_DB, "profiles": {}}
    for name, kv_pool in PROFILES.items():
        final_j, traj_j = jax_chain(params, cond, x_T, steps, kv_pool)
        log(f"[ckpt] JAX {name} chain done at {time.time() - t0:.0f} s")
        final_t, traj_t = port_chain(port_pipeline(kv_pool), cond, x_T, steps)
        log(f"[ckpt] port {name} chain done at {time.time() - t0:.0f} s")
        arrays[f"final_{name}"] = final_j
        psnr_j, psnr_t = psnr_per_image(final_j, hr), psnr_per_image(final_t, hr)
        delta = [abs(a - b) for a, b in zip(psnr_j, psnr_t)]
        report["profiles"][name] = {
            "ca_kv_pool": kv_pool, "psnr_jax": psnr_j, "psnr_port_cpu": psnr_t, "abs_delta_db": delta,
            "within_bar": max(delta) <= BAR_DB,
            "final_image_max_abs_delta": float(np.abs(final_j - final_t).max()),
            "traced_vs_production_final_delta": float(np.abs(cond + traj_j[-1] - final_j).max()),
            "per_step_max_abs_delta": [float(np.abs(a - b).max()) for a, b in zip(traj_j, traj_t)],
        }
        # The bf16 serving chain of the reference, for the card's bf16 chains to be read against.
        final_b, _ = jax_chain(params, cond, x_T, steps, kv_pool, "bfloat16", traced=False)
        log(f"[ckpt] JAX {name} bf16 chain done at {time.time() - t0:.0f} s")
        arrays[f"final_{name}_bf16"] = final_b
        report["profiles"][name]["psnr_jax_bf16"] = psnr_per_image(final_b, hr)
    for side in ("psnr_jax", "psnr_port_cpu"):
        exact, fast = report["profiles"]["exact"][side], report["profiles"]["fast"][side]
        report[f"fast_minus_exact_{side}"] = [f - e for f, e in zip(fast, exact)]
    report["fast_minus_exact_ci95_parity_r07_256"] = list(FAST_MINUS_EXACT_CI95)
    report["fast_minus_exact_note"] = "for information only: n = 2 images, the interval is from n = 128 pairs"
    report["elapsed_s"] = time.time() - t0
    return arrays, report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--npz", default=str(REPO / "PARITY_TORCH_CKPT_ref.npz"))
    ap.add_argument("--json", default=str(REPO / "PARITY_TORCH_CKPT.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    arrays, report = run(args.steps, args.images)
    np.savez_compressed(args.npz, **arrays)
    Path(args.json).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps({k: v["abs_delta_db"] for k, v in report["profiles"].items()}), flush=True)


if __name__ == "__main__":
    main()
