"""Seeded inputs and weights, made on the device in a few large draws.

The benchmark makes every weight itself, from ``--seed``, and hands the same
values to the program and to the plain reference: the program's modules are
filled in place by name, the reference's from the same tensors.  Each
parameter is uniform in a range set by its role, as PyTorch's own
initialisation would set it: a weight of fan-in f and its bias in
[-1/sqrt(f), 1/sqrt(f)], a norm's scale in [0.9, 1.1] and its shift in
[-0.1, 0.1].  All values come from one draw of ``torch.rand`` on a device
generator; each parameter is a slice of it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

NORMS = (nn.GroupNorm, nn.LayerNorm)


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws, from any whole ``seed`` (negative or past 64 bits too)."""
    words = [int(w) for w in np.frombuffer(int(seed % (1 << 128)).to_bytes(16, "little"), np.uint32)]
    state = np.random.SeedSequence(words + [int(s) for s in stream]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int, *stream: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


def ranges(module: nn.Module) -> list[tuple[str, tuple[int, ...], float, float]]:
    """``(name, shape, low, high)`` of every parameter of ``module``, in ``named_parameters`` order."""
    out = []
    for prefix, m in module.named_modules():
        weight = getattr(m, "weight", None)
        fan_in = weight[0].numel() if isinstance(weight, torch.Tensor) and weight.ndim >= 2 else None
        for pname, p in m.named_parameters(recurse=False):
            name = f"{prefix}.{pname}" if prefix else pname
            if isinstance(m, NORMS):
                lo, hi = (0.9, 1.1) if pname == "weight" else (-0.1, 0.1)
            elif p.ndim >= 2:
                b = 1.0 / math.sqrt(p[0].numel())
                lo, hi = -b, b
            elif fan_in is not None:
                b = 1.0 / math.sqrt(fan_in)
                lo, hi = -b, b
            else:
                lo, hi = -0.1, 0.1
            out.append((name, tuple(p.shape), lo, hi))
    return out


def make(spec, seed: int, stream: int, dtype: torch.dtype, device="cuda") -> dict[str, torch.Tensor]:
    """The parameters ``spec`` (from :func:`ranges`) describes, in ``dtype`` on ``device``: one uniform draw
    for them all, each parameter a slice of it scaled to its range."""
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    flat = torch.rand(total, generator=generator(seed, stream, device=device), device=device)
    out, at = {}, 0
    for name, shape, lo, hi in spec:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * (hi - lo) + lo).to(dtype).reshape(shape)
        at += n
    return out


@torch.no_grad()
def load(module: nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; the two sets of names must be the same."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"parameter names differ: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} against {tuple(weights[name].shape)}")
        p.copy_(weights[name])
