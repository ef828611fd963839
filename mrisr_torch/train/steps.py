"""Train steps of the main path (port of ``mrisr_tpu/train/steps.py``).

One factory per pipeline; each returns ``step(state, batch, generator,
draws=None) -> (state, {"loss": ...})``.  Batches are dicts of ``[B, H, W, 1]``
images, as in the reference (an MNIST batch also holds ``label``, ``[B]``);
the models run NCHW.  The latent family's factories are in ``train/latent.py``.

On a CUDA device the step is one captured ``torch.cuda.CUDAGraph``
(``cuda_graph=True``, the default): the random draws, the forward, the
backward (through the flash-attention and GroupNorm+SiLU kernels) and the
optimizer and EMA updates in place.  The first call warms the step up twice
on a copy of the state on a side stream (cuDNN, cuFFT and the kernels'
one-time set-up happen there), then captures it; every call copies the batch
into the graph's static inputs, puts the caller's generator state into the
generator registered with the graph, replays, and hands the advanced state
back to the caller's generator, so a replay draws what the eager step draws.
A graphed step updates ``state`` in place and returns that same object; it
is bound to the state it captured (and to one batch shape) and raises on
another, or on ``draws``.  Its metrics are fresh tensors each call.  The eager
step (CPU, or ``cuda_graph=False``) returns a new state and leaves the one it
was given as it was.  A step the graph cannot capture raises; nothing falls
back to the eager step.

Random draws.  The reference splits one PRNG key four ways; here one
``torch.Generator`` (on the batch's device) feeds, in this order: ``t``
(``randint(0, T)``, ``[B]``), the uniform behind ``gamma`` (``[B]``), ``eps``
(``randn`` of the image shape) and then the dropout masks in the order the
UNet applies them.  ``draws`` may hold ``"gamma"`` (``[B]``) or ``"eps"``
(NCHW); an entry given there is used as it is and not drawn (nor is ``t``
when ``gamma`` is given).  The MNIST DDPM step draws ``t`` (``randint(0,
T)``, ``[B]``) and then ``eps``; ``draws`` may hold either.

A parameter the loss does not reach (the MNIST UNet's time and class
embeddings in regression mode) gets a zero gradient, as under ``jax.grad``,
so the optimizer steps it as optax does.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mrisr_torch.device import resolve_device
from mrisr_torch.diffusion import ddpm, sr3
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
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves.values(), grads)]
    return loss.detach(), dict(zip(leaves, grads))


def _prepare(model: nn.Module, device: str | torch.device) -> torch.device:
    dev = resolve_device(device)
    model.to(dev).train()
    return dev


def _advanced(gen_state: torch.Tensor, by: int) -> torch.Tensor:
    """A CUDA generator state (seed, Philox offset: two 64-bit words) with its offset moved on by ``by``."""
    state = gen_state.clone()
    state.view(torch.int64)[1] += by
    return state


class GraphedStep:
    """One training step captured as a CUDA graph and replayed (see the module docstring).

    ``body(state, inputs, generator, regen)`` runs one step in place on
    ``state`` from the NCHW ``inputs`` and returns the loss (or a dict of
    metrics, the loss among them); ``regen`` is the
    second registered generator a remat step recomputes its forward with
    (None otherwise).  ``keys`` names the batch entries copied in.
    """

    def __init__(self, body, device: torch.device, keys: tuple[str, ...], random: bool, remat: bool = False,
                 probe=None):
        self.body, self.device, self.keys = body, device, keys
        self.random, self.remat, self.probe = random, remat, probe
        self.graph: torch.cuda.CUDAGraph | None = None
        self.state: TrainState | None = None
        self.inputs: dict[str, torch.Tensor] = {}
        self.gens: list[torch.Generator] = []
        self.regen_offset = 0
        self.metrics: dict[str, torch.Tensor] = {}

    def _capture(self, state: TrainState, inputs: dict, generator) -> None:
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.gens = [torch.Generator(device=self.device) for _ in range(2 if self.remat else 1)] if self.random else []
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warm = state.clone()
            for _ in range(2):
                gen = None
                if self.random:
                    gen = torch.Generator(device=self.device)
                    gen.set_state(generator.get_state())
                    start = gen.get_state()
                    if self.remat:
                        self.regen_offset = self.probe(start, gen, self.inputs)
                        gen.set_state(start)
                self.body(warm, self.inputs, gen, None)
            del warm
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.gens:
            graph.register_generator_state(gen)
        gen, regen = (self.gens + [None, None])[:2]
        # thread_local: the loader's thread may pin host memory meanwhile, which is no work of the capture.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.body(state, self.inputs, gen, regen)
        self.metrics = out if isinstance(out, dict) else {"loss": out}
        graph.instantiate()
        self.graph, self.state = graph, state

    def __call__(self, state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        if draws:
            raise ValueError("a graphed step draws its own t, gamma and eps; use cuda_graph=False to pass draws")
        if self.random and (generator is None or generator.device.type != "cuda"):
            raise ValueError("a graphed step needs a CUDA torch.Generator")
        inputs = {k: _nchw(batch[k]) if batch[k].ndim == 4 else batch[k] for k in self.keys}
        if self.graph is None:
            self._capture(state, {k: v.to(self.device) for k, v in inputs.items()}, generator)
        elif state is not self.state:
            raise ValueError("this graphed step is bound to the state it captured; pass that state "
                             "(restore a checkpoint into it with CheckpointManager.restore(..., in_place=True))")
        for k, v in inputs.items():
            static = self.inputs[k]
            if v.shape != static.shape:
                raise ValueError(f"a graphed step takes one batch shape: {k} is {tuple(v.shape)}, "
                                 f"captured {tuple(static.shape)}")
            static.copy_(v, non_blocking=True)
        if self.random:
            start = generator.get_state()
            self.gens[0].set_state(start)
            if self.remat:
                self.gens[1].set_state(_advanced(start, self.regen_offset))
        self.graph.replay()
        if self.random:
            generator.set_state(self.gens[0].get_state())
        state.step += 1
        return state, {k: v.clone() for k, v in self.metrics.items()}


def _graphed(device: torch.device, cuda_graph: bool) -> bool:
    return cuda_graph and device.type == "cuda"


def make_cnn_train_step(model: nn.Module, policy: Policy | None = None, device: str | torch.device = "cuda",
                        cuda_graph: bool = True):
    """Stage 1: image-compare loss of ``model(lr)`` against HR.  Puts ``model`` in training mode."""
    policy = policy or Policy()
    dev = _prepare(model, device)

    def loss_and_grads(params, lr, hr):
        def loss_fn(params):
            pred = functional_call(model, policy.cast_to_compute(params), (policy.cast_to_compute(lr),))
            return image_compare_loss(pred.float(), hr.float())

        return _value_and_grad(loss_fn, params)

    if _graphed(dev, cuda_graph):
        def body(state, inputs, generator, regen):
            loss, grads = loss_and_grads(state.params, inputs["lr"], inputs["hr"])
            state.update_tensors_(grads)
            return loss

        return GraphedStep(body, dev, ("lr", "hr"), random=False)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        loss, grads = loss_and_grads(state.params, _nchw(batch["lr"]), _nchw(batch["hr"]))
        return state.apply_gradients(grads), {"loss": loss}

    return step


def make_resdiff_train_step(
    unet: nn.Module,
    sched: Schedule,
    policy: Policy | None = None,
    remat: bool = False,
    device: str | torch.device = "cuda",
    cuda_graph: bool = True,
):
    """Stage 2: diffuse the residual ``hr - sr``, predict eps, MSE.

    Puts ``unet`` in training mode (dropout on).  With a bf16 ``policy`` the
    UNet forward and backward run in bfloat16 against the fp32 master
    parameters; the q-sample and the loss stay fp32.  ``remat=True`` recomputes
    the UNet forward in the backward pass instead of keeping its activations;
    the recomputation sees the dropout masks of the first pass: the eager step
    puts the generator back to its state from before the forward, and a graphed
    step recomputes from a second registered generator set to that state (its
    Philox offset measured in the warm-up), since a generator's state cannot be
    set inside a capture.
    """
    policy = policy or Policy()
    dev = _prepare(unet, device)
    sched = sched.to(dev)

    def apply_unet(params, inp, gamma, generator, regen):
        if not remat:
            return functional_call(unet, params, (inp, gamma), {"generator": generator})
        before = None if generator is None or regen is not None else generator.get_state()
        calls = []

        def forward(inp, gamma, *values):
            gen = generator
            if calls and regen is not None:  # the recomputation of a graphed step
                gen = regen
            elif before is not None:
                generator.set_state(before)
            calls.append(1)
            return functional_call(unet, dict(zip(params, values)), (inp, gamma), {"generator": gen})

        return checkpoint(forward, inp, gamma, *params.values(), use_reentrant=False, preserve_rng_state=False)

    def draw(sr, hr, generator, draws, probe=None):
        """``(x_t input, gamma, eps)``; ``probe(generator)`` runs after the draws, before the UNet's."""
        b = hr.shape[0]
        if "gamma" in draws:
            gamma = draws["gamma"]
        else:
            t = torch.randint(0, sched.num_timesteps, (b,), generator=generator, device=hr.device)
            gamma = sr3.sample_gamma(sched, t, generator)
        eps = draws["eps"] if "eps" in draws else torch.randn(
            hr.shape, generator=generator, device=hr.device, dtype=hr.dtype)
        x_t = sr3.q_sample_gamma(hr - sr, gamma, eps)
        return policy.cast_to_compute(torch.cat([sr, x_t], dim=1)), gamma, eps

    def loss_and_grads(params, sr, hr, generator, draws, regen=None):
        inp, gamma, eps = draw(sr, hr, generator, draws)

        def loss_fn(params):
            eps_pred = apply_unet(policy.cast_to_compute(params), inp, gamma, generator, regen)
            return l2(eps_pred.float(), eps.float())

        return _value_and_grad(loss_fn, params)

    if _graphed(dev, cuda_graph):
        def body(state, inputs, generator, regen):
            loss, grads = loss_and_grads(state.params, inputs["sr"], inputs["hr"], generator, {}, regen)
            state.update_tensors_(grads)
            return loss

        def probe(start, generator, inputs):
            """The Philox offset the step's draws of t, gamma and eps take (the UNet's draws start there)."""
            with torch.no_grad():
                draw(inputs["sr"], inputs["hr"], generator, {})
            return int(generator.get_state().view(torch.int64)[1] - start.view(torch.int64)[1])

        return GraphedStep(body, dev, ("sr", "hr"), random=True, remat=remat, probe=probe)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        loss, grads = loss_and_grads(state.params, _nchw(batch["sr"]), _nchw(batch["hr"]), generator, draws or {})
        return state.apply_gradients(grads), {"loss": loss}

    return step


def make_mnist_regression_step(model: nn.Module, device: str | torch.device = "cuda", cuda_graph: bool = True):
    """MNIST regression: MSE of ``model(lr_up)`` (no timestep, no label) against HR.  Puts ``model`` in
    training mode."""
    dev = _prepare(model, device)

    def loss_and_grads(params, lr_up, hr):
        return _value_and_grad(lambda p: l2(functional_call(model, p, (lr_up,)), hr), params)

    if _graphed(dev, cuda_graph):
        def body(state, inputs, generator, regen):
            loss, grads = loss_and_grads(state.params, inputs["lr_up"], inputs["hr"])
            state.update_tensors_(grads)
            return loss

        return GraphedStep(body, dev, ("hr", "lr_up"), random=False)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        loss, grads = loss_and_grads(state.params, _nchw(batch["lr_up"]), _nchw(batch["hr"]))
        return state.apply_gradients(grads), {"loss": loss}

    return step


def make_mnist_ddpm_step(model: nn.Module, sched: Schedule, device: str | torch.device = "cuda",
                         cuda_graph: bool = True):
    """Conditional DDPM: ``model(concat(x_t, lr_up), t, label) -> eps``, MSE against ``eps``.  A graphed
    step copies ``label`` in when the model has classes; the eager one uses it when the batch holds it."""
    dev = _prepare(model, device)
    sched = sched.to(dev)

    def loss_and_grads(params, hr, lr_up, label, generator, draws):
        b = hr.shape[0]
        t = draws["t"].to(hr.device) if "t" in draws else torch.randint(
            0, sched.num_timesteps, (b,), generator=generator, device=hr.device)
        eps = draws["eps"].to(hr.device) if "eps" in draws else torch.randn(
            hr.shape, generator=generator, device=hr.device, dtype=hr.dtype)
        x_t = ddpm.q_sample(sched, hr, t, eps)
        inp = torch.cat([x_t, lr_up], dim=1)
        return _value_and_grad(lambda p: l2(functional_call(model, p, (inp, t, label)), eps), params)

    if _graphed(dev, cuda_graph):
        keys = ("hr", "lr_up") + (("label",) if getattr(model, "num_classes", 0) > 0 else ())

        def body(state, inputs, generator, regen):
            loss, grads = loss_and_grads(state.params, inputs["hr"], inputs["lr_up"], inputs.get("label"),
                                         generator, {})
            state.update_tensors_(grads)
            return loss

        return GraphedStep(body, dev, keys, random=True)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None, draws=None):
        label = batch.get("label")
        hr = _nchw(batch["hr"])
        loss, grads = loss_and_grads(state.params, hr, _nchw(batch["lr_up"]),
                                     None if label is None else torch.as_tensor(label).to(hr.device), generator,
                                     draws or {})
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
    scans the steps inside one compiled program; here each step is one graph
    replay on a card, or one eager step.)  Returns ``(state, losses [K])``;
    on a card ``state`` is the one given, updated in place.
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
