"""Training state, optimizers and LR schedules (port of ``mrisr_tpu/train/state.py``).

The reference builds its optimizer from optax pieces; the port holds to their
semantics, which differ from the obvious torch ones in places:

* ``grad_accum=k`` keeps the running *mean* of k micro-gradients, emits zero
  updates on the first k-1 calls and the inner update of the mean on the k-th,
  then multiplies the mean by 0 (a NaN in it stays, and the non-finite skip
  goes on skipping, as under ``optax.MultiSteps``);
* ``max_grad_norm`` clips by the global norm *before* Adam;
* ``skip_nonfinite`` skips parameters and optimizer state on a NaN/inf
  gradient (and gives up after 100 consecutive ones, applying the update);
* ``TrainState.apply_gradients`` bumps ``step`` and updates the EMA on every
  call, micro-steps included;
* an LR schedule is read at the number of updates made so far (0 first);
* ``kind="adafactor"`` is ``optax.adafactor(lr)`` with its defaults: the
  factored second-moment estimate (two largest dims, each >= 128, chosen
  by ``np.argsort`` of the shape), block-RMS clipping at 1, the learning
  rate, scaling by the parameter's RMS (at least 1e-3), descent.  A zero
  gradient (a parameter the loss does not reach) still enters the moments
  with ``eps`` added to its square, as in optax.

An optimizer is ``(init, update, update_)``, one of the two updates given.
``update_(grads, state, params, gate=None)`` updates the parameters and the
optimizer state in place, with ``torch._foreach_*`` ops, and is what a CUDA
graph captures: every count (Adam's step, the accumulation's micro-step, the
non-finite streak) is a 0-d device tensor, the learning rate and the bias
corrections are computed from them on the device, and every choice
(accumulate or emit, apply or skip) is a ``torch.where`` over a 0-d boolean
``gate``, never a Python branch on a device value.  ``make_optimizer``'s
optimizers have only ``update_``.  A hand-made ``Optimizer(init, update)``,
with ``update(grads, state, params) -> (updates, new_state)`` changing
nothing in place, trains eagerly and cannot be captured.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch import nn

from mrisr_torch.device import resolve_device

Params = dict[str, torch.Tensor]
Schedule = Callable[[int | torch.Tensor], float | torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], tuple[Params, dict]] | None = None
    update_: Callable[..., None] | None = None


# ---------------------------------------------------------------------------
# LR schedules: functions of the number of updates made so far, a Python int (-> float) or a 0-d device
# tensor (-> a 0-d float32 tensor, so a CUDA graph reads the schedule at every replay)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count):
        if isinstance(count, torch.Tensor):
            frac = 1.0 - count.clamp(0, steps).to(torch.float32) / steps
        else:
            frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    def schedule(count):
        if isinstance(count, torch.Tensor):
            return torch.where(count < boundary, first(count), second(count - boundary))
        return first(count) if count < boundary else second(count - boundary)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: ``init * ((1 - alpha) * 0.5 * (1 + cos(pi * min(n, steps) / steps)) +
    alpha)``; it stays at ``init * alpha`` from ``decay_steps`` on."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(count):
        if isinstance(count, torch.Tensor):
            frac = count.clamp(max=decay_steps).to(torch.float32) / decay_steps
            return init_value * ((1.0 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * frac)) + alpha)
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


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
        return _join(_linear(0.0, base_lr, warmup), cosine_decay_schedule(base_lr, decay_steps), warmup)
    if name == "linear":
        return _join(
            _linear(0.0, base_lr, max(warmup_steps, 1)),
            _linear(base_lr, 0.0, max(total_steps - warmup_steps, 1)),
            warmup_steps,
        )
    raise ValueError(f"unknown lr schedule {name!r}")


# ---------------------------------------------------------------------------
# Optimizer pieces: in-place updates over lists of tensors, gated by a 0-d bool tensor
# ---------------------------------------------------------------------------


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


def _count(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=_device(params))


def _and(gate: torch.Tensor | None, cond: torch.Tensor) -> torch.Tensor:
    return cond if gate is None else gate & cond


def _commit(dst: list[torch.Tensor], new: list[torch.Tensor], gate: torch.Tensor | None) -> None:
    """``dst[i] = new[i]`` in place where ``gate`` holds (everywhere when it is None)."""
    if gate is not None:
        new = [torch.where(gate, n, d) for n, d in zip(new, dst)]
    torch._foreach_copy_(dst, new)


def _commit_one(dst: torch.Tensor, new: torch.Tensor, gate: torch.Tensor | None) -> None:
    dst.copy_(new if gate is None else torch.where(gate, new, dst))


def _adam(lr: float | Schedule, b1: float, b2: float, eps: float, weight_decay: float | None) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` (not None) makes it AdamW."""
    lr_at = lr if callable(lr) else (lambda count: lr)

    def init(params: Params) -> dict:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": _count(params), "mu": zeros, "nu": {k: z.clone() for k, z in zeros.items()}}

    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        keys = list(params)
        g = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        step_lr = lr_at(state["count"])
        count = state["count"] + 1
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        new_mu = torch._foreach_mul(mu, b1)
        torch._foreach_add_(new_mu, g, alpha=1.0 - b1)
        new_nu = torch._foreach_mul(nu, b2)
        torch._foreach_addcmul_(new_nu, g, g, value=1.0 - b2)
        den = torch._foreach_div(new_nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(torch._foreach_div(new_mu, c1), den)
        if weight_decay is not None:
            torch._foreach_add_(u, p, alpha=weight_decay)
        torch._foreach_mul_(u, -step_lr)
        _commit(mu, new_mu, gate)
        _commit(nu, new_nu, gate)
        _commit(p, torch._foreach_add(p, u), gate)
        _commit_one(state["count"], count, gate)

    return Optimizer(init, update_=update_)


def _factored_dims(shape: tuple[int, ...], min_dim_size_to_factor: int) -> tuple[int, int] | None:
    """optax's choice: the two largest dims (``np.argsort`` of the shape), when the smaller is large
    enough; a vector is never factored."""
    import numpy as np

    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def _adafactor(lr: float | Schedule, decay_rate: float = 0.8, eps: float = 1e-30, min_dim_size_to_factor: int = 128,
               clipping_threshold: float = 1.0, min_scale: float = 1e-3) -> Optimizer:
    """``optax.adafactor(lr)`` with its defaults (see the module docstring); one count for the moments'
    decay ``1 - (n + 1)^-decay_rate`` and the schedule."""
    lr_at = lr if callable(lr) else (lambda count: lr)

    def init(params: Params) -> dict:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            dims = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
            if dims is None:
                v[k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                v_row[k] = torch.zeros_like(p.select(d0, 0))
                v_col[k] = torch.zeros_like(p.select(d1, 0))
        return {"count": _count(params), "v_row": v_row, "v_col": v_col, "v": v}

    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        count = state["count"]
        decay = 1.0 - (count.to(torch.float32) + 1.0) ** (-decay_rate)
        step_lr = lr_at(count)
        for k, p in params.items():
            g = grads[k]
            g2 = g * g + eps
            if k in state["v"]:
                v = decay * state["v"][k] + (1.0 - decay) * g2
                u = g * v ** -0.5
                _commit_one(state["v"][k], v, gate)
            else:
                d1, d0 = _factored_dims(tuple(p.shape), min_dim_size_to_factor)
                v_row = decay * state["v_row"][k] + (1.0 - decay) * g2.mean(dim=d0)
                v_col = decay * state["v_col"][k] + (1.0 - decay) * g2.mean(dim=d1)
                row_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                u = g * ((v_row / row_mean) ** -0.5).unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                _commit_one(state["v_row"][k], v_row, gate)
                _commit_one(state["v_col"][k], v_col, gate)
            u = u / torch.clamp(_block_rms(u) / clipping_threshold, min=1.0)
            u = u * step_lr
            rms = _block_rms(p)
            u = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)
            _commit_one(p, p - u, gate)
        _commit_one(state["count"], count + 1, gate)

    return Optimizer(init, update_=update_)


def multi_transform(transforms: dict[str, Optimizer], label_of: Callable[[str], str]) -> Optimizer:
    """``optax.multi_transform``: each parameter goes to ``transforms[label_of(name)]``; the state holds each
    transform's state under its label."""
    def split(tree: Params, label: str) -> Params:
        return {k: v for k, v in tree.items() if label_of(k) == label}

    def init(params: Params) -> dict:
        unknown = {label_of(k) for k in params} - set(transforms)
        if unknown:
            raise KeyError(f"no transform for labels {sorted(unknown)}")
        return {label: tx.init(sub) for label, tx in transforms.items() if (sub := split(params, label))}

    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        for label, tx in transforms.items():
            sub = split(params, label)
            if sub:
                tx.update_({k: grads[k] for k in sub}, state[label], sub, gate)

    return Optimizer(init, update_=update_)


def _clip_by_global_norm(max_norm: float, inner: Optimizer) -> Optimizer:
    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        keys = list(grads)
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm([grads[k].float() for k in keys])))
        # Unclipped below max_norm, else scaled to it (selected on the device).
        factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
        clipped = torch._foreach_mul([grads[k] for k in keys], factor)
        inner.update_(dict(zip(keys, clipped)), state, params, gate)

    return Optimizer(inner.init, update_=update_)


def _apply_if_finite(inner: Optimizer, max_consecutive_errors: int) -> Optimizer:
    def init(params: Params) -> dict:
        return {"notfinite_count": _count(params), "total_notfinite": _count(params), "inner": inner.init(params)}

    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        count = torch.where(finite, torch.zeros_like(state["notfinite_count"]), state["notfinite_count"] + 1)
        total = state["total_notfinite"] + (~finite).to(torch.int64)
        inner.update_(grads, state["inner"], params, _and(gate, finite | (count > max_consecutive_errors)))
        _commit_one(state["notfinite_count"], count, gate)
        _commit_one(state["total_notfinite"], total, gate)

    return Optimizer(init, update_=update_)


def _multi_steps(inner: Optimizer, every_k: int) -> Optimizer:
    def init(params: Params) -> dict:
        return {"mini_step": _count(params), "gradient_step": _count(params), "inner": inner.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update_(grads: Params, state: dict, params: Params, gate: torch.Tensor | None = None) -> None:
        keys = list(state["acc_grads"])
        acc = [state["acc_grads"][k] for k in keys]
        n = state["mini_step"]
        delta = torch._foreach_sub([grads[k] for k in keys], acc)
        torch._foreach_div_(delta, (n + 1).to(torch.float32))
        new_acc = torch._foreach_add(acc, delta)
        emit = n == every_k - 1
        inner.update_(dict(zip(keys, new_acc)), state["inner"], params, _and(gate, emit))
        # optax resets the accumulator as (1 - emit) * acc, which keeps a NaN in it after the emit.
        _commit(acc, torch._foreach_mul(new_acc, (~emit).to(new_acc[0].dtype)), gate)
        _commit_one(state["mini_step"], torch.where(emit, torch.zeros_like(n), n + 1), gate)
        _commit_one(state["gradient_step"], state["gradient_step"] + emit.to(torch.int64), gate)

    return Optimizer(init, update_=update_)


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
        tx = _adafactor(lr)
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


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same structure), in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"structure differs: {sorted(set(dst) ^ set(src))}")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif dst != src:
        raise ValueError(f"{dst!r} != {src!r}")


@dataclass
class TrainState:
    """fp32 master parameters by name, optimizer state, step count and the EMA.

    ``apply_gradients`` returns a new state and leaves this one as it was;
    ``apply_gradients_`` updates this one in place (the form a CUDA graph
    captures).  ``step`` is counted on the host.  The names are the
    module's, so ``module.load_state_dict(state.params)`` (or
    ``state.ema_params``) writes them back.
    """

    params: Params
    tx: Optimizer
    opt_state: dict
    step: int = 0
    ema_params: Params | None = None
    ema_decay: float = 0.0

    def clone(self) -> "TrainState":
        """A copy of every tensor; the optimizer is shared."""
        return TrainState(_clone(self.params), self.tx, _clone(self.opt_state), self.step,
                          _clone(self.ema_params), self.ema_decay)

    def _ema_(self) -> None:
        """``ema = d ema + (1 - d) params``, in place, as one lerp toward the parameters."""
        if self.ema_params is not None:
            keys = list(self.ema_params)
            torch._foreach_lerp_([self.ema_params[k] for k in keys], [self.params[k] for k in keys],
                                 1.0 - self.ema_decay)

    def update_tensors_(self, grads: Params) -> None:
        """Update the parameters, optimizer state and EMA in place: the device work of a step (what a CUDA
        graph captures; ``step`` is left to the caller)."""
        if self.tx.update_ is None:
            raise TypeError("this optimizer has no in-place update (Optimizer.update_)")
        self.tx.update_(grads, self.opt_state, self.params)
        self._ema_()

    def apply_gradients_(self, grads: Params) -> None:
        """``update_tensors_`` and one more step."""
        self.update_tensors_(grads)
        self.step += 1

    def apply_gradients(self, grads: Params) -> "TrainState":
        if self.tx.update_ is not None:
            new = self.clone()
            new.apply_gradients_(grads)
            return new
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        params = {k: p + updates[k] for k, p in self.params.items()}
        new = TrainState(params, self.tx, opt_state, self.step + 1, _clone(self.ema_params), self.ema_decay)
        new._ema_()
        return new

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

    def load_state_dict_(self, tree: dict) -> "TrainState":
        """Copy ``tree``'s contents into this state's own tensors (a CUDA graph that captured them still sees
        them) and return this state."""
        if set(tree["params"]) != set(self.params):
            raise KeyError("checkpoint parameters do not match the state's")
        if (tree["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and state differ in having an EMA")
        _copy_into(self.params, tree["params"])
        _copy_into(self.opt_state, tree["opt_state"])
        if self.ema_params is not None:
            _copy_into(self.ema_params, tree["ema_params"])
        self.step, self.ema_decay = int(tree["step"]), float(tree["ema_decay"])
        return self


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def create_train_state(
    module: nn.Module | Params, tx: Optimizer, ema_decay: float = 0.0, device: str | torch.device = "cuda"
) -> TrainState:
    """A state on ``device`` from ``module``'s parameters, or from a ``name -> tensor`` dict (copied,
    float32)."""
    dev = resolve_device(device)
    named = module.named_parameters() if isinstance(module, nn.Module) else module.items()
    params = {k: p.detach().to(dev, torch.float32, copy=True) for k, p in named}
    ema = {k: p.clone() for k, p in params.items()} if ema_decay > 0 else None
    return TrainState(params, tx, tx.init(params), 0, ema, ema_decay)
