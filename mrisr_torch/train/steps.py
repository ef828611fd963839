"""Train steps of the main path (port of ``mrisr_tpu/train/steps.py``).

One factory per pipeline; each returns ``step(state, batch, generator,
draws=None) -> (state, {"loss": ...})``.  Batches are dicts of ``[B, H, W, 1]``
images, as in the reference; the models run NCHW.  The MNIST and latent
factories are not ported yet.

Random draws.  The reference splits one PRNG key four ways; here one
``torch.Generator`` (on the batch's device) feeds, in this order: ``t``
(``randint(0, T)``, ``[B]``), the uniform behind ``gamma`` (``[B]``), ``eps``
(``randn`` of the image shape) and then the dropout masks in the order the
UNet applies them.  ``draws`` may hold ``"gamma"`` (``[B]``) or ``"eps"``
(NCHW); an entry given there is used as it is and not drawn (nor is ``t``
when ``gamma`` is given).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion import sr3
from mrisr_torch.diffusion.schedules import Schedule
from mrisr_torch.train.losses import image_compare_loss, l2
from mrisr_torch.train.precision import Policy
from mrisr_torch.train.state import Params, TrainState


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` -> NCHW-contiguous ``[B, C, H, W]``.

    With one channel both layouts are one reshape; a permute would leave
    channels-last strides for the convolutions to carry on to the NCHW kernels.
    """
    b, h, w, c = x.shape
    return x.reshape(b, 1, h, w) if c == 1 else x.permute(0, 3, 1, 2).contiguous()


def step_generator(seed: int, step_id: int, device: str | torch.device) -> torch.Generator:
    """The generator of step ``step_id`` of a run seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(((int(seed) << 32) ^ int(step_id)) & (2**63 - 1))


def _value_and_grad(loss_fn: Callable[[Params], torch.Tensor], params: Params):
    """Loss and its gradients with respect to the (float32) ``params``, by name."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _prepare(model: nn.Module, device: str | torch.device) -> torch.device:
    dev = resolve_device(device)
    model.to(dev).train()
    return dev


def make_cnn_train_step(model: nn.Module, policy: Policy | None = None, device: str | torch.device = "cuda"):
    """Stage 1: image-compare loss of ``model(lr)`` against HR.  Puts ``model`` in training mode."""
    policy = policy or Policy()
    _prepare(model, device)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        lr, hr = _nchw(batch["lr"]), _nchw(batch["hr"])

        def loss_fn(params):
            pred = functional_call(model, policy.cast_to_compute(params), (policy.cast_to_compute(lr),))
            return image_compare_loss(pred.float(), hr.float())

        loss, grads = _value_and_grad(loss_fn, state.params)
        return state.apply_gradients(grads), {"loss": loss}

    return step


def make_resdiff_train_step(
    unet: nn.Module,
    sched: Schedule,
    policy: Policy | None = None,
    remat: bool = False,
    device: str | torch.device = "cuda",
):
    """Stage 2: diffuse the residual ``hr - sr``, predict eps, MSE.

    Puts ``unet`` in training mode (dropout on).  With a bf16 ``policy`` the
    UNet forward and backward run in bfloat16 against the fp32 master
    parameters; the q-sample and the loss stay fp32.  ``remat=True`` recomputes
    the UNet forward in the backward pass instead of keeping its activations;
    the recomputation sees the dropout masks of the first pass, because the
    generator is put back to its state from before the forward.
    """
    policy = policy or Policy()
    dev = _prepare(unet, device)
    sched = sched.to(dev)

    def apply_unet(params, inp, gamma, generator):
        if not remat:
            return functional_call(unet, params, (inp, gamma), {"generator": generator})
        before = None if generator is None else generator.get_state()

        def forward(inp, gamma, *values):
            if generator is not None:
                generator.set_state(before)
            return functional_call(unet, dict(zip(params, values)), (inp, gamma), {"generator": generator})

        return checkpoint(forward, inp, gamma, *params.values(), use_reentrant=False, preserve_rng_state=False)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        draws = draws or {}
        sr, hr = _nchw(batch["sr"]), _nchw(batch["hr"])
        b = hr.shape[0]
        if "gamma" in draws:
            gamma = draws["gamma"]
        else:
            t = torch.randint(0, sched.num_timesteps, (b,), generator=generator, device=hr.device)
            gamma = sr3.sample_gamma(sched, t, generator)
        eps = draws["eps"] if "eps" in draws else torch.randn(
            hr.shape, generator=generator, device=hr.device, dtype=hr.dtype)
        x_t = sr3.q_sample_gamma(hr - sr, gamma, eps)
        inp = policy.cast_to_compute(torch.cat([sr, x_t], dim=1))

        def loss_fn(params):
            eps_pred = apply_unet(policy.cast_to_compute(params), inp, gamma, generator)
            return l2(eps_pred.float(), eps.float())

        loss, grads = _value_and_grad(loss_fn, state.params)
        return state.apply_gradients(grads), {"loss": loss}

    return step


def make_resdiff_train_many(
    unet: nn.Module,
    sched: Schedule,
    policy: Policy | None = None,
    remat: bool = False,
    device: str | torch.device = "cuda",
):
    """K steps over a device-resident set: ``many(state, sr_all, hr_all, idx, step_ids, seed)``.

    Step ``i`` trains on ``(sr_all[idx[i]], hr_all[idx[i]])`` with
    ``step_generator(seed, step_ids[i], device)``, so a call reproduces the
    per-step loop that derives its generators the same way.  (The reference
    scans the steps inside one compiled program to spare dispatches; eager
    PyTorch has none to spare, so this is a plain loop.)  Returns
    ``(state, losses [K])``.
    """
    step = make_resdiff_train_step(unet, sched, policy, remat, device)

    def many(state: TrainState, sr_all, hr_all, idx, step_ids, seed: int):
        losses = []
        for ix, sid in zip(torch.as_tensor(idx), step_ids):
            ix = ix.to(sr_all.device)
            gen = step_generator(seed, int(sid), sr_all.device)
            state, metrics = step(state, {"sr": sr_all[ix], "hr": hr_all[ix]}, gen)
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return many


def make_cnn_train_many(model: nn.Module, policy: Policy | None = None, device: str | torch.device = "cuda"):
    """K stage-1 steps over a device-resident set: ``many(state, lr_all, hr_all, idx)``."""
    step = make_cnn_train_step(model, policy, device)

    def many(state: TrainState, lr_all, hr_all, idx):
        losses = []
        for ix in torch.as_tensor(idx):
            ix = ix.to(lr_all.device)
            state, metrics = step(state, {"lr": lr_all[ix], "hr": hr_all[ix]})
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return many
