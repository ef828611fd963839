"""Training steps of the latent family: VAE, base UNet, ControlNet, LoRA, T2I-Adapter and ControlNet+LoRA
(port of ``mrisr_tpu/train/latent.py``).

Each latent step VAE-encodes the HR and LR slices (or samples the posterior
from cached moments), diffuses the HR latents toward the LR anchor with the
res-shift forward process, predicts epsilon (or the sample) and takes the MSE.
Gradients go to the trained module only; the VAE and the UNet (the base of a
LoRA) are frozen: the factories set ``requires_grad_(False)`` on them, so a
backward computes no gradient of their weights.  The ControlNet and the
ControlNet+LoRA steps run the two encoder towers as one program over two lanes
(``models/fused.py``) when ``fused`` says so; ``None``, the default, fuses
whenever the two configurations match, as the reference does.  The stacked
weights are made inside each step, so the gradient reaches the ControlNet lane
through them (the frozen UNet lane's weight gradient is computed and dropped).
CFG dropout swaps a sample's prompt embedding for the empty one with
probability ``proportion_empty_prompts``; there is none when ``empty_embeds``
is None.

Every factory returns ``step(state, batch, generator, draws=None) -> (state,
metrics)`` (the frozen modules are bound at construction, where the reference
passes them to each call as ``frozen``).  Batches are dicts of ``[B, H, W,
C]`` arrays: ``hr`` and ``lr`` pixels, or with ``latents_cached=True`` the
posterior moments ``hr_mean``, ``hr_logvar``, ``lr_mean`` and ``lr_logvar``
(``[B, h, w, 4]``) beside the ``lr`` pixels the ControlNet and the adapter
take as their condition.  On a CUDA device a step is one captured CUDA graph
(``train/steps.py::GraphedStep``; ``cuda_graph=False`` runs it eagerly).

Random draws.  The reference splits one PRNG key four ways; here one
``torch.Generator`` on the batch's device feeds, in this order: the HR and
the LR posterior noise (``randn`` of the latent shape), ``t`` (``randint(0,
T)``, ``[B]``), ``eps`` (``randn`` of the latent shape) and the CFG drop mask
(``rand([B]) < p``).  ``draws`` may hold any of ``"hr_noise"``,
``"lr_noise"``, ``"t"``, ``"eps"`` (NCHW) and ``"drop"``; one given there is
used as it is and not drawn.  The VAE step draws only its posterior noise
(``"noise"``).

State parameters are flat ``name -> tensor`` dicts (``TrainState``): a
module's parameter names; LoRA factors as ``lora_params`` names them; and for
ControlNet+LoRA both, under ``cn/`` and ``lora/`` (``cn_lora_params``); ``create_train_state`` takes
such a dict as it takes a module.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion import res_shift
from mrisr_torch.diffusion.schedules import Schedule
from mrisr_torch.models.fused import fused_eps, resolve_fused, stack_tower_params
from mrisr_torch.models.lora import apply_lora_delta
from mrisr_torch.parallel.mesh import average_gradients
from mrisr_torch.train.losses import l2
from mrisr_torch.train.state import Params, TrainState
from mrisr_torch.train.steps import GraphedStep, _graphed, _nchw, _value_and_grad, step_generator

CACHED_KEYS = ("hr_mean", "hr_logvar", "lr_mean", "lr_logvar")
PREDICTION_TYPES = ("epsilon", "sample")


# ---------------------------------------------------------------------------
# Flat parameter names of LoRA factors and of the ControlNet+LoRA pair
# ---------------------------------------------------------------------------


def lora_params(lora: dict[tuple[str, ...], dict[str, torch.Tensor]], prefix: str = "") -> Params:
    """``{path: {"a", "b"}}`` -> ``{"<prefix><path joined by />/a": a, ...}``."""
    return {f"{prefix}{'/'.join(path)}/{k}": t for path, ab in lora.items() for k, t in ab.items()}


def lora_tree(params: Params, prefix: str = "") -> dict[tuple[str, ...], dict[str, torch.Tensor]]:
    """The inverse of :func:`lora_params` over the names that start with ``prefix``."""
    lora: dict[tuple[str, ...], dict[str, torch.Tensor]] = {}
    for name, t in params.items():
        if name.startswith(prefix):
            *path, k = name[len(prefix):].split("/")
            lora.setdefault(tuple(path), {})[k] = t
    return lora


def cn_lora_params(controlnet: nn.Module, lora: dict) -> Params:
    """The ControlNet's parameters under ``cn/`` and the LoRA factors under ``lora/``."""
    return {**{f"cn/{k}": p for k, p in controlnet.named_parameters()}, **lora_params(lora, "lora/")}


def _prefixed(params: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class _Method(nn.Module):
    """``module.<name>`` as a forward, so ``functional_call`` runs a method other than ``forward``."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.module, self.name = module, name

    def forward(self, *args):
        return getattr(self.module, self.name)(*args)


def _call_method(module: nn.Module, params: Params, name: str, *args):
    return functional_call(_Method(module, name), {f"module.{k}": v for k, v in params.items()}, args)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _rgb(x: torch.Tensor) -> torch.Tensor:
    """A one-channel NCHW image repeated to three channels."""
    return x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x


def _normal(draws: dict, name: str, shape, like: torch.Tensor, generator) -> torch.Tensor:
    if name in draws:
        return draws[name].to(like.device, like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _posterior(mean, logvar, noise):
    """``AutoencoderKL.encode``'s sample: ``mean + exp(logvar / 2) * noise``."""
    return mean + torch.exp(0.5 * logvar) * noise


def _encode_pair(vae, inputs: dict, generator, draws: dict, latents_cached: bool):
    """The scaled (hr, lr) latents of a step: the frozen VAE's posterior samples of the pixels, or with
    ``latents_cached`` samples from the cached moments, by one formula (equal at equal noise)."""
    out = []
    for side in ("hr", "lr"):
        if latents_cached:
            mean, logvar = inputs[f"{side}_mean"], inputs[f"{side}_logvar"]
        else:
            with torch.no_grad():
                mean, logvar = vae.encode_moments(_rgb(inputs[side]))
        noise = _normal(draws, f"{side}_noise", mean.shape, mean, generator)
        out.append(_posterior(mean, logvar, noise) * vae.scaling_factor)
    return out


def _diffused_batch(sched: Schedule, hr_lat, lr_lat, generator, draws: dict):
    """``(x_t, t, eps)``: ``x_t`` float32 from the res-shift forward process."""
    b = hr_lat.shape[0]
    t = draws["t"].to(hr_lat.device) if "t" in draws else torch.randint(
        0, sched.num_timesteps, (b,), generator=generator, device=hr_lat.device)
    eps = _normal(draws, "eps", hr_lat.shape, hr_lat, generator)
    return res_shift.shift_forward(sched, hr_lat, lr_lat, t, eps), t, eps


def _context(prompt, empty, b: int, p: float, generator, draws: dict):
    """The prompt embedding for each of ``b`` samples, each swapped for ``empty`` with probability ``p``."""
    ctx = prompt[:1].expand(b, *prompt.shape[1:])
    if p <= 0.0 or empty is None:
        return ctx
    drop = draws["drop"].to(ctx.device) if "drop" in draws else torch.rand(
        (b,), generator=generator, device=ctx.device) < p
    return torch.where(drop.bool()[:, None, None], empty, ctx)


def _latent_step(predict: Callable, trained: tuple[nn.Module, ...], frozen: tuple[nn.Module, ...], vae, sched,
                 prompt_embeds, empty_embeds, proportion_empty_prompts: float, prediction_type: str,
                 latents_cached: bool, cond_pixels: bool, device, cuda_graph: bool, mesh=None):
    """A latent train step around ``predict(params, inputs, x_t, t, ctx) -> model output`` (NCHW); with
    ``mesh`` the loss and gradients are averaged over its ``"data"`` axis (``parallel/mesh.py``)."""
    if prediction_type not in PREDICTION_TYPES:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    dev = resolve_device(device)
    for m in trained:
        m.to(dev).train()
    for m in (vae, *frozen):
        m.to(dev).requires_grad_(False)
    sched = sched.to(dev)
    prompt = prompt_embeds.to(dev)
    empty = None if empty_embeds is None else empty_embeds.to(dev)
    keys = (("lr",) if cond_pixels or not latents_cached else ()) + (CACHED_KEYS if latents_cached else ("hr",))

    def loss_and_grads(params, inputs, generator, draws):
        hr_lat, lr_lat = _encode_pair(vae, inputs, generator, draws, latents_cached)
        x_t, t, eps = _diffused_batch(sched, hr_lat, lr_lat, generator, draws)
        ctx = _context(prompt, empty, hr_lat.shape[0], proportion_empty_prompts, generator, draws)
        target = hr_lat if prediction_type == "sample" else eps
        loss, grads = _value_and_grad(lambda p: l2(predict(p, inputs, x_t, t, ctx), target), params)
        return (loss, grads) if mesh is None else average_gradients(mesh, loss, grads)

    if _graphed(dev, cuda_graph):
        def body(state, inputs, generator, regen):
            loss, grads = loss_and_grads(state.params, inputs, generator, {})
            state.update_tensors_(grads)
            return loss

        return GraphedStep(body, dev, keys, random=True)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        inputs = {k: _nchw(batch[k]) for k in keys}
        loss, grads = loss_and_grads(state.params, inputs, generator, draws or {})
        return state.apply_gradients(grads), {"loss": loss}

    return step


# ---------------------------------------------------------------------------
# The factories
# ---------------------------------------------------------------------------


def make_vae_train_step(vae: nn.Module, kl_weight: float = 1e-6, device: str | torch.device = "cuda",
                        cuda_graph: bool = True):
    """AutoencoderKL training on ``batch["img"]`` (1 or 3 channels): reconstruction MSE + ``kl_weight`` x
    KL(q(z|x) || N(0, I)); metrics ``loss``, ``rec`` and ``kl``.  ``state.params`` are the VAE's."""
    dev = resolve_device(device)
    vae.to(dev).train()

    def loss_and_grads(params, img, generator, draws):
        x = _rgb(img)
        aux = {}

        def loss_fn(p):
            mean, logvar = _call_method(vae, p, "encode_moments", x)
            z = _posterior(mean, logvar, _normal(draws, "noise", mean.shape, mean, generator))
            rec = l2(_call_method(vae, p, "decode", z), x)
            kl = 0.5 * torch.mean(torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2, 3)))
            aux.update(rec=rec.detach(), kl=kl.detach())
            return rec + kl_weight * kl

        loss, grads = _value_and_grad(loss_fn, params)
        return {"loss": loss, **aux}, grads

    if _graphed(dev, cuda_graph):
        def body(state, inputs, generator, regen):
            metrics, grads = loss_and_grads(state.params, inputs["img"], generator, {})
            state.update_tensors_(grads)
            return metrics

        return GraphedStep(body, dev, ("img",), random=True)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        metrics, grads = loss_and_grads(state.params, _nchw(batch["img"]), generator, draws or {})
        return state.apply_gradients(grads), metrics

    return step


def make_latent_base_train_step(unet, vae, sched: Schedule, prompt_embeds, empty_embeds=None,
                                proportion_empty_prompts: float = 0.1, prediction_type: str = "epsilon",
                                latents_cached: bool = False, device: str | torch.device = "cuda",
                                cuda_graph: bool = True, mesh=None):
    """Base latent-diffusion training: ``state.params`` are the UNet's."""
    def predict(p, inputs, x_t, t, ctx):
        return functional_call(unet, p, (x_t, t, ctx))

    return _latent_step(predict, (unet,), (), vae, sched, prompt_embeds, empty_embeds, proportion_empty_prompts,
                        prediction_type, latents_cached, False, device, cuda_graph, mesh)


def _fused_predict(unet, controlnet, unet_params: Params | None, cn_params: Params, x_t, t, ctx, cond_image):
    """The fused towers' prediction with the ControlNet's parameters ``cn_params`` (and the UNet's
    ``unet_params``, its own when None), stacked here, inside the step."""
    prefix = "controlnet_cond_embedding."
    emb = functional_call(controlnet.controlnet_cond_embedding,
                          {k[len(prefix):]: v for k, v in cn_params.items() if k.startswith(prefix)}, (cond_image,))
    stacked = stack_tower_params(unet, dict(unet.named_parameters()) if unet_params is None else unet_params,
                                 cn_params)
    return fused_eps(unet, controlnet, stacked, x_t, t, ctx, emb, unet_params, cn_params)


def make_controlnet_train_step(unet, controlnet, vae, sched: Schedule, prompt_embeds, empty_embeds=None,
                               proportion_empty_prompts: float = 0.1, fused: bool | None = None,
                               prediction_type: str = "epsilon", latents_cached: bool = False,
                               device: str | torch.device = "cuda", cuda_graph: bool = True, mesh=None):
    """ControlNet fine-tuning: ``state.params`` are the ControlNet's; the UNet is frozen.  ``fused``: the
    two towers as one program (module docstring)."""
    fused = resolve_fused(fused, unet, controlnet)

    def predict(p, inputs, x_t, t, ctx):
        if fused:
            return _fused_predict(unet, controlnet, None, p, x_t, t, ctx, _rgb(inputs["lr"]))
        down, mid = functional_call(controlnet, p, (x_t, t, ctx), {"cond_image": _rgb(inputs["lr"])})
        return unet(x_t, t, ctx, down_block_additional_residuals=down, mid_block_additional_residual=mid)

    return _latent_step(predict, (controlnet,), (unet,), vae, sched, prompt_embeds, empty_embeds,
                        proportion_empty_prompts, prediction_type, latents_cached, True, device, cuda_graph, mesh)


def make_lora_train_step(unet, vae, sched: Schedule, prompt_embeds, lora_alpha: float = 1.0, empty_embeds=None,
                         proportion_empty_prompts: float = 0.1, prediction_type: str = "epsilon",
                         latents_cached: bool = False, device: str | torch.device = "cuda",
                         cuda_graph: bool = True, mesh=None):
    """LoRA fine-tuning: ``state.params`` are the factors (``lora_params``); the UNet's own weights are the
    frozen base, merged with the factors functionally each step."""
    def predict(p, inputs, x_t, t, ctx):
        return functional_call(unet, apply_lora_delta(unet, lora_tree(p), lora_alpha), (x_t, t, ctx))

    return _latent_step(predict, (), (unet,), vae, sched, prompt_embeds, empty_embeds, proportion_empty_prompts,
                        prediction_type, latents_cached, False, device, cuda_graph, mesh)


def make_adapter_train_step(unet, adapter, vae, sched: Schedule, prompt_embeds, empty_embeds=None,
                            proportion_empty_prompts: float = 0.1, prediction_type: str = "epsilon",
                            latents_cached: bool = False, device: str | torch.device = "cuda",
                            cuda_graph: bool = True, mesh=None):
    """T2I-Adapter fine-tuning: ``state.params`` are the adapter's; its features add into the frozen UNet's
    down blocks."""
    def predict(p, inputs, x_t, t, ctx):
        feats = functional_call(adapter, p, (_rgb(inputs["lr"]),))
        return unet(x_t, t, ctx, adapter_features=feats)

    return _latent_step(predict, (adapter,), (unet,), vae, sched, prompt_embeds, empty_embeds,
                        proportion_empty_prompts, prediction_type, latents_cached, True, device, cuda_graph, mesh)


def make_cn_lora_train_step(unet, controlnet, vae, sched: Schedule, prompt_embeds, lora_alpha: float = 1.0,
                            empty_embeds=None, proportion_empty_prompts: float = 0.1, fused: bool | None = None,
                            prediction_type: str = "epsilon", latents_cached: bool = False,
                            device: str | torch.device = "cuda", cuda_graph: bool = True, mesh=None):
    """ControlNet and LoRA trained jointly (the reference notebook's configuration): ``state.params`` are
    ``cn_lora_params``; the UNet is the frozen base of the LoRA.  ``fused``: the two towers as one program
    over the LoRA-merged UNet's weights (module docstring)."""
    fused = resolve_fused(fused, unet, controlnet)

    def predict(p, inputs, x_t, t, ctx):
        merged = apply_lora_delta(unet, lora_tree(p, "lora/"), lora_alpha)
        if fused:
            return _fused_predict(unet, controlnet, merged, _prefixed(p, "cn/"), x_t, t, ctx, _rgb(inputs["lr"]))
        down, mid = functional_call(controlnet, _prefixed(p, "cn/"), (x_t, t, ctx), {"cond_image": _rgb(inputs["lr"])})
        return functional_call(unet, merged, (x_t, t, ctx), {"down_block_additional_residuals": down,
                                                             "mid_block_additional_residual": mid})

    return _latent_step(predict, (controlnet,), (unet,), vae, sched, prompt_embeds, empty_embeds,
                        proportion_empty_prompts, prediction_type, latents_cached, True, device, cuda_graph, mesh)


# ---------------------------------------------------------------------------
# K steps over a device-resident set
# ---------------------------------------------------------------------------


def _many(step, gather):
    def loop(state, data, idx, step_ids, seed: int):
        rows = []
        device = next(iter(data.values())).device
        for ix, sid in zip(torch.as_tensor(idx), step_ids):
            ix = ix.to(device)
            state, m = step(state, {k: v[ix] for k, v in data.items()}, step_generator(seed, int(sid), device))
            rows.append(gather(m))
        return state, torch.stack(rows)

    return loop


def make_latent_train_many(step):
    """K steps of a latent ``step`` over a device-resident set: ``many(state, lr_all, hr_all, idx, step_ids,
    seed) -> (state, losses [K])``.  Step ``i`` trains on row ``idx[i]`` of ``lr_all`` and ``hr_all`` with
    ``step_generator(seed, step_ids[i], device)``, so a call reproduces the loop of steps that derives its
    generators the same way.  (The reference scans the steps inside one compiled program; here each step is
    one graph replay on a card, or one eager step.)"""
    loop = _many(step, lambda m: m["loss"])

    def many(state, lr_all, hr_all, idx, step_ids, seed: int):
        return loop(state, {"lr": lr_all, "hr": hr_all}, idx, step_ids, seed)

    return many


def make_vae_train_many(step):
    """K VAE steps: ``many(state, pool, idx, step_ids, seed) -> (state, [K, 3])``, rows ``(loss, rec, kl)``;
    batches and generators as in :func:`make_latent_train_many`."""
    loop = _many(step, lambda m: torch.stack([m["loss"], m["rec"], m["kl"]]))

    def many(state, pool, idx, step_ids, seed: int):
        return loop(state, {"img": pool}, idx, step_ids, seed)

    return many


def make_latent_train_many_cached(step):
    """K steps over a cached-latent set: ``many(state, arrays, idx, step_ids, seed) -> (state, losses [K])``,
    ``arrays`` a dict of stacked per-image arrays (the ``latents_cached=True`` batch keys); batch ``i``
    gathers row ``idx[i]`` of every array."""
    loop = _many(step, lambda m: m["loss"])

    def many(state, arrays, idx, step_ids, seed: int):
        return loop(state, dict(arrays), idx, step_ids, seed)

    return many
