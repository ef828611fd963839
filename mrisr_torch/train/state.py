"""Training state, optimizers and LR schedules (port of ``mrisr_tpu/train/state.py``).

The reference builds its optimizer from optax pieces; the port holds to their
semantics, which differ from the obvious torch ones in places:

* an optimizer is a pair ``(init, update)`` of pure functions on
  ``{name: tensor}`` dicts: ``update(grads, state, params) -> (updates,
  new_state)`` changes nothing in place, so a rejected step leaves the old
  state as it was;
* ``grad_accum=k`` keeps the running *mean* of k micro-gradients, emits zero
  updates on the first k-1 calls and the inner update of the mean on the k-th;
* ``max_grad_norm`` clips by the global norm *before* Adam;
* ``skip_nonfinite`` skips parameters and optimizer state on a NaN/inf
  gradient (and gives up after 100 consecutive ones, applying the update);
* ``TrainState.apply_gradients`` bumps ``step`` and updates the EMA on every
  call, micro-steps included;
* an LR schedule is read at the number of updates made so far (0 first).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch import nn

from mrisr_torch.device import resolve_device

Params = dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], tuple[Params, dict]]


# ---------------------------------------------------------------------------
# LR schedules: plain functions of the step
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(
    name: str = "constant",
    base_lr: float = 1e-4,
    warmup_steps: int = 0,
    total_steps: int = 100_000,
) -> Schedule:
    """'constant' (with optional warmup) | 'cosine' (with warmup) | 'linear'."""
    if name == "constant":
        if warmup_steps > 0:
            return _linear(0.0, base_lr, warmup_steps)
        return lambda count: base_lr
    if name == "cosine":
        warmup = max(warmup_steps, 1)
        decay_steps = max(total_steps, warmup + 1) - warmup

        def cosine(count: int) -> float:
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))

        return _join(_linear(0.0, base_lr, warmup), cosine, warmup)
    if name == "linear":
        return _join(
            _linear(0.0, base_lr, max(warmup_steps, 1)),
            _linear(base_lr, 0.0, max(total_steps - warmup_steps, 1)),
            warmup_steps,
        )
    raise ValueError(f"unknown lr schedule {name!r}")


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------


def _adam(lr: float | Schedule, b1: float, b2: float, eps: float, weight_decay: float | None) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` (not None) makes it AdamW."""
    lr_at = lr if callable(lr) else (lambda count: lr)

    def init(params: Params) -> dict:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": 0, "mu": zeros, "nu": {k: z.clone() for k, z in zeros.items()}}

    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        count = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1.0 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1.0 - b2) * g * g for k, g in grads.items()}
        c1, c2 = 1.0 - b1**count, 1.0 - b2**count
        step_lr = lr_at(state["count"])
        updates = {}
        for k in grads:
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[k]
            updates[k] = -step_lr * u
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _clip_by_global_norm(max_norm: float, inner: Optimizer) -> Optimizer:
    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        g_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        # Unclipped below max_norm, else scaled to it (selected on the device: no host sync).
        below = g_norm < max_norm
        clipped = {k: torch.where(below, g, (g / g_norm.to(g.dtype)) * max_norm) for k, g in grads.items()}
        return inner.update(clipped, state, params)

    return Optimizer(inner.init, update)


def _apply_if_finite(inner: Optimizer, max_consecutive_errors: int) -> Optimizer:
    def init(params: Params) -> dict:
        return {"notfinite_count": 0, "total_notfinite": 0, "inner": inner.init(params)}

    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
        count = 0 if finite else state["notfinite_count"] + 1
        total = state["total_notfinite"] + (0 if finite else 1)
        if finite or count > max_consecutive_errors:
            updates, inner_state = inner.update(grads, state["inner"], params)
        else:
            updates, inner_state = {k: torch.zeros_like(g) for k, g in grads.items()}, state["inner"]
        return updates, {"notfinite_count": count, "total_notfinite": total, "inner": inner_state}

    return Optimizer(init, update)


def _multi_steps(inner: Optimizer, every_k: int) -> Optimizer:
    def init(params: Params) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads: Params, state: dict, params: Params) -> tuple[Params, dict]:
        n = state["mini_step"]
        acc = {k: a + (grads[k] - a) / (n + 1) for k, a in state["acc_grads"].items()}
        if n < every_k - 1:
            zeros = {k: torch.zeros_like(g) for k, g in grads.items()}
            return zeros, {**state, "mini_step": n + 1, "acc_grads": acc}
        updates, inner_state = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1, "inner": inner_state,
                         "acc_grads": {k: torch.zeros_like(a) for k, a in acc.items()}}

    return Optimizer(init, update)


def make_optimizer(
    lr: float | Schedule = 1e-4,
    kind: str = "adam",
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: float | None = None,
    grad_accum: int = 1,
    skip_nonfinite: bool = False,
) -> Optimizer:
    if kind == "adam":
        tx = _adam(lr, b1, b2, eps, None)
    elif kind == "adamw":
        tx = _adam(lr, b1, b2, eps, weight_decay)
    elif kind == "adafactor":
        # The reference's stand-in for 8-bit Adam on the TPU; torch has no
        # optimizer that equals optax.adafactor.
        raise NotImplementedError("adafactor is not ported; use 'adam' or 'adamw'")
    else:
        raise ValueError(f"unknown optimizer {kind!r}")
    if max_grad_norm is not None:
        tx = _clip_by_global_norm(max_grad_norm, tx)
    if skip_nonfinite:
        tx = _apply_if_finite(tx, max_consecutive_errors=100)
    if grad_accum > 1:
        tx = _multi_steps(tx, grad_accum)
    return tx


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """fp32 master parameters by name, optimizer state, step count and the EMA.

    ``apply_gradients`` returns a new state and leaves this one as it was.
    The names are the module's, so ``module.load_state_dict(state.params)``
    (or ``state.ema_params``) writes them back.
    """

    params: Params
    tx: Optimizer
    opt_state: dict
    step: int = 0
    ema_params: Params | None = None
    ema_decay: float = 0.0

    def apply_gradients(self, grads: Params) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        params = {k: p + updates[k] for k, p in self.params.items()}
        ema = self.ema_params
        if ema is not None:
            d = self.ema_decay
            ema = {k: d * e + (1.0 - d) * params[k] for k, e in ema.items()}
        return TrainState(params, self.tx, opt_state, self.step + 1, ema, self.ema_decay)

    def state_dict(self) -> dict:
        """What a checkpoint holds: tensors, ints and floats in plain dicts."""
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step,
                "ema_params": self.ema_params, "ema_decay": self.ema_decay}

    def load_state_dict(self, tree: dict) -> "TrainState":
        """A state with this one's optimizer and device, and ``tree``'s contents."""
        device = next(iter(self.params.values())).device
        if set(tree["params"]) != set(self.params):
            raise KeyError("checkpoint parameters do not match the state's")
        tree = _to_device(tree, device)
        return TrainState(tree["params"], self.tx, tree["opt_state"], int(tree["step"]),
                          tree["ema_params"], float(tree["ema_decay"]))


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def create_train_state(
    module: nn.Module, tx: Optimizer, ema_decay: float = 0.0, device: str | torch.device = "cuda"
) -> TrainState:
    """A state on ``device`` from ``module``'s parameters (copied, float32)."""
    dev = resolve_device(device)
    params = {k: p.detach().to(dev, torch.float32, copy=True) for k, p in module.named_parameters()}
    ema = {k: p.clone() for k, p in params.items()} if ema_decay > 0 else None
    return TrainState(params, tx, tx.init(params), 0, ema, ema_decay)
