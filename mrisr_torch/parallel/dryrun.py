"""Multi-device dry run: the port's counterpart of the reference's ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device)`` starts ``n`` rank processes (spawned, torch
on one thread each; NCCL with one GPU a rank on CUDA, the default, which
raises when there are fewer GPUs than ranks; gloo with ``device="cpu"``; the
rendezvous is a file in a temporary directory) and runs the reference's five
legs at its tiny shapes, each held to its single-device result:

1. a data-parallel ResDiff stage-2 step (``make_resdiff_train_step(mesh=)``,
   eager, each rank on its rows with its rows of the whole batch's draws)
   against one step on the whole batch; on CUDA also the graphed
   data-parallel step against the eager one from the same generator;
2. a dp x tp ``SDUNet`` value-and-grad (output channels of every conv and
   Linear of at least 16 split over ``"model"``, gradients averaged over
   ``"data"``) against the unsharded model on the whole batch;
3. the 5-step DDIM ResDiff chain under batch sharding
   (``super_resolve_rows``, rows gathered) against the whole batch's chain;
4. ``super_resolve_volume`` over the ResDiff pipeline, mesh-sharded against single-device;
5. the latent (ControlNet + SDUNet + VAE) volume, likewise.

The UNet of legs 1, 3 and 4 has no dropout, so that a rank's step can draw
what the whole batch's step draws (the reference's leg keeps the default
dropout and checks only that the loss is finite).  Rank 0 returns each leg's
largest difference; ``run_legs`` runs them in a process that has already
joined a process group (``chip_smoke.py`` runs them at world size 1).

    python -m mrisr_torch.parallel.dryrun --n 4                # 4 GPUs, NCCL
    python -m mrisr_torch.parallel.dryrun --n 4 --device cpu   # CPU, gloo
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZE = 16  # the reference's tiny ResDiff shapes
SD_TINY = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
LATENT_SIZE = 64  # 8^2 latents: the smallest grid the tiny UNet's three downsamples admit
LOSS_TOL, PARAM_TOL, GRAD_TOL, OUT_TOL = 1e-5, 2e-5, 2e-5, 1e-4


def _unet(device):
    from mrisr_torch.models.resdiff_unet import ResDiffUNet

    torch.manual_seed(0)
    return ResDiffUNet(image_size=SIZE, inner_channel=8, norm_groups=4, dropout=0.0, device=device)


def _close(name, got, want, tol) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: max |sharded - single| {err:.3e} over {tol}")
    return err


def leg_dp_step(mesh, device) -> dict:
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.parallel.mesh import batch_sharding, replicate_params
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_resdiff_train_step, step_generator

    unet, sched = _unet(device), resdiff_schedule(100)
    replicate_params(mesh, unet)
    n = dist.get_world_size()
    b = 2 * n
    rng = np.random.default_rng(0)
    batch = {"sr": torch.zeros((b, SIZE, SIZE, 1), device=device),
             "hr": torch.from_numpy(rng.normal(0, 0.1, (b, SIZE, SIZE, 1)).astype(np.float32)).to(device)}
    draws = {"gamma": torch.from_numpy(rng.uniform(0.1, 0.9, b).astype(np.float32)).to(device),
             "eps": torch.from_numpy(rng.standard_normal((b, 1, SIZE, SIZE)).astype(np.float32)).to(device)}
    rows = batch_sharding(mesh).rows(b)
    tx = make_optimizer(1e-4)
    single = make_resdiff_train_step(unet, sched, device=device, cuda_graph=False)
    dp = make_resdiff_train_step(unet, sched, device=device, cuda_graph=False, mesh=mesh)
    want, mw = single(create_train_state(unet, tx, device=device), batch, None, draws)
    got, mg = dp(create_train_state(unet, tx, device=device), {k: v[rows] for k, v in batch.items()}, None,
                 {k: v[rows] for k, v in draws.items()})
    out = {"loss": float(mg["loss"]), "loss_err": _close("dp step loss", mg["loss"], mw["loss"], LOSS_TOL),
           "param_err": max(_close(f"dp step {k}", got.params[k], p, PARAM_TOL) for k, p in want.params.items())}
    if torch.device(device).type == "cuda":  # the graphed data-parallel step (its all-reduce captured)
        graphed = make_resdiff_train_step(unet, sched, device=device, mesh=mesh)
        local = {k: v[rows] for k, v in batch.items()}
        a, ma = graphed(create_train_state(unet, tx, device=device), local, step_generator(1, 0, device))
        e, me = dp(create_train_state(unet, tx, device=device), local, step_generator(1, 0, device))
        out["graph_loss_err"] = _close("graphed dp step loss", ma["loss"], me["loss"], LOSS_TOL)
        out["graph_param_err"] = max(_close(f"graphed dp step {k}", a.params[k], p, PARAM_TOL)
                                     for k, p in e.params.items())
    return out


def leg_dp_tp(device) -> dict:
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.parallel.mesh import average_gradients, batch_sharding, make_mesh_2d, shard_params_tp

    n = dist.get_world_size()
    mp_size = 2 if n % 2 == 0 else 1
    mesh = make_mesh_2d(n // mp_size, mp_size)
    torch.manual_seed(1)
    ref = SDUNet(**SD_TINY, device=device)
    sd = SDUNet(**SD_TINY, device=device)
    sd.load_state_dict(ref.state_dict())
    split = shard_params_tp(mesh, sd, min_channels=16)
    rng = np.random.default_rng(0)
    b = n
    x, eps = (torch.from_numpy(rng.standard_normal((b, 4, 16, 16)).astype(np.float32)).to(device) for _ in range(2))
    ctx = torch.from_numpy(rng.standard_normal((b, 7, 16)).astype(np.float32)).to(device)
    t = torch.arange(b, device=device)

    def value_and_grad(model, rows):
        model.zero_grad()
        loss = torch.mean((model(x[rows], t[rows], ctx[rows]) - eps[rows]) ** 2)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in model.named_parameters()}

    want_loss, want = value_and_grad(ref, slice(None))
    loss, grads = average_gradients(mesh, *value_and_grad(sd, batch_sharding(mesh).rows(b)))
    r = mesh.get_local_rank("model")
    errs = [_close(f"dp x tp grad {k}", g, want[k] if g.shape == want[k].shape else want[k].chunk(mp_size, 0)[r],
                   GRAD_TOL) for k, g in grads.items()]
    return {"mesh": [n // mp_size, mp_size], "split_layers": len(split), "loss": float(loss),
            "loss_err": _close("dp x tp loss", loss, want_loss, LOSS_TOL), "grad_err": max(errs)}


def _resdiff_pipeline(device):
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    torch.manual_seed(2)
    cnn = SimpleCNN(device=device)
    return ResDiffPipeline(cnn, _unet(device), resdiff_schedule(100), device=device)


def leg_sampler(mesh, device) -> dict:
    from mrisr_torch.parallel.mesh import batch_sharding

    pipe = _resdiff_pipeline(device)
    n = dist.get_world_size()
    lr = torch.from_numpy(np.random.default_rng(1).normal(0, 0.3, (2 * n, SIZE, SIZE, 1)).astype(np.float32))
    lr = lr.to(device)
    gen = lambda: torch.Generator(device=device).manual_seed(3)  # noqa: E731
    want = pipe.super_resolve(lr, gen(), num_steps=5)
    sh = batch_sharding(mesh)
    got = sh.gather(pipe.super_resolve_rows(lr, sh.rows(len(lr)), gen(), num_steps=5))
    return {"max_abs_diff": _close("sampler dp", got, want, OUT_TOL)}


def _volumes(mesh, pipe, vol, **kw) -> float:
    from mrisr_torch.data.nifti import write_nifti
    from mrisr_torch.pipelines.volume import super_resolve_volume

    with tempfile.TemporaryDirectory() as td:
        src = f"{td}/vol.nii"
        if dist.get_rank() == 0:
            write_nifti(src, vol, np.eye(4))
        shared = [src]
        dist.broadcast_object_list(shared, src=0)  # rank 0's path: one directory is written
        single = super_resolve_volume(pipe, shared[0], None, chain_group=2, **kw)
        sharded = super_resolve_volume(pipe, shared[0], None, mesh=mesh, chain_group=2, **kw)
        dist.barrier()
    if single.data.shape != vol.shape:
        raise AssertionError(f"volume shape {single.data.shape}, source {vol.shape}")
    return _close("volume mesh-sharded", torch.from_numpy(sharded.data), torch.from_numpy(single.data), OUT_TOL)


def leg_volume(mesh, device) -> dict:
    n = dist.get_world_size()
    vol = (np.random.default_rng(7).random((14, 12, 5)) * 600).astype(np.float32)
    err = _volumes(mesh, _resdiff_pipeline(device), vol, axis=2, resolution=SIZE, batch_size=n, num_steps=3, seed=3)
    return {"max_abs_diff": err}


def leg_latent_volume(mesh, device) -> dict:
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.pipelines.latent import LatentSRPipeline

    torch.manual_seed(4)
    unet, cn = SDUNet(**SD_TINY, device=device), ControlNet(**SD_TINY, device=device)
    vae = AutoencoderKL(block_out_channels=(8, 8, 16, 16), device=device)
    pipe = LatentSRPipeline(unet, cn, vae, sd15_schedule(zero_terminal_snr=False, timesteps=50),
                            torch.full((1, 7, 16), 0.1), device=device)
    n = dist.get_world_size()
    vol = (np.random.default_rng(8).random((20, 18, 2 * n)) * 600).astype(np.float32)
    err = _volumes(mesh, pipe, vol, axis=2, resolution=LATENT_SIZE, batch_size=n, num_steps=2, seed=3)
    return {"fused_towers": pipe.fused_towers, "max_abs_diff": err}


def run_legs(device: str = "cuda") -> dict:
    """The five legs in this process, which has joined the process group; every rank calls it."""
    from mrisr_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    return {"world": dist.get_world_size(), "backend": dist.get_backend(),
            "dp_step": leg_dp_step(mesh, device), "dp_tp": leg_dp_tp(device),
            "sampler": leg_sampler(mesh, device), "volume": leg_volume(mesh, device),
            "latent_volume": leg_latent_volume(mesh, device)}


def _rank_main(rank: int, n: int, device: str, rendezvous: str, results) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=n)
    try:
        out = run_legs(f"cuda:{rank}" if device == "cuda" else "cpu")
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int = 4, device: str = "cuda") -> dict:
    """Run the five legs on ``n`` rank processes (one GPU each on CUDA; ``device="cpu"`` for gloo on the
    host); rank 0's results.  Raises if a rank fails, or on CUDA if there are fewer GPUs than ranks."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} GPUs; {torch.cuda.device_count()} visible (device='cpu' runs "
                           "them on the host)")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as td:
        mp.start_processes(_rank_main, args=(n, device, os.path.join(td, "rendezvous"), results), nprocs=n,
                           join=True, start_method="spawn")
    return results.get()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4, help="rank processes")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
