"""LoRA as weight deltas on the port's ``nn.Linear`` weights (port of ``mrisr_tpu/models/lora.py``).

A LoRA dict maps the Flax-style path of a Linear's weight (the port's module
names joined as the reference's tree is: ``("down_blocks_0", ...,
"to_q", "kernel")``) to its factors ``{"a": [in, rank], "b": [rank, out]}``,
the reference's layout, so a dict made by either package fits the other.
The reference's delta ``(alpha / rank) * a @ b`` is ``[in, out]``; a torch
weight is ``[out, in]``, so the port adds its transpose.

Targets are the 2-D weights of ``nn.Linear`` modules whose path matches one
of ``target_patterns`` (by default the attention projections).
"""
from __future__ import annotations

import re

import torch
from torch import nn

DEFAULT_TARGETS = (r"to_q", r"to_k", r"to_v", r"to_out")


def flax_path(param_name: str) -> tuple[str, ...]:
    """``"a.b.to_q.weight"`` -> ``("a", "b", "to_q", "kernel")``."""
    *mods, leaf = param_name.split(".")
    return tuple(mods) + ("kernel" if leaf == "weight" else leaf,)


def lora_targets(module: nn.Module, target_patterns=DEFAULT_TARGETS) -> dict[tuple[str, ...], str]:
    """Flax-style path -> parameter name, for every Linear weight whose path matches a pattern."""
    out = {}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            path = flax_path(f"{name}.weight")
            if any(re.search(p, "/".join(path)) for p in target_patterns):
                out[path] = f"{name}.weight"
    return out


def init_lora_params(
    module: nn.Module,
    rank: int = 4,
    target_patterns=DEFAULT_TARGETS,
    generator: torch.Generator | None = None,
) -> dict[tuple[str, ...], dict[str, torch.Tensor]]:
    """Factors for every target: ``a`` normal / rank, ``b`` zeros, so the first delta is zero."""
    params = dict(module.named_parameters())
    lora = {}
    for path, name in lora_targets(module, target_patterns).items():
        w = params[name]
        d_out, d_in = w.shape
        a = torch.randn((d_in, rank), generator=generator, device=w.device, dtype=torch.float32) / rank
        lora[path] = {"a": a.to(w.dtype), "b": torch.zeros((rank, d_out), device=w.device, dtype=w.dtype)}
    return lora


def _delta(ab: dict[str, torch.Tensor], alpha: float) -> torch.Tensor:
    """``(alpha / rank) * (a @ b)^T``, in the torch weight's ``[out, in]`` layout."""
    return ((alpha / ab["a"].shape[1]) * (ab["a"] @ ab["b"])).T


def apply_lora_delta(
    module: nn.Module, lora: dict[tuple[str, ...], dict[str, torch.Tensor]], alpha: float = 1.0
) -> dict[str, torch.Tensor]:
    """The merged parameters ``{name: W + delta}`` (differentiable in the factors), for
    ``torch.func.functional_call``; the module is not changed."""
    params = dict(module.named_parameters())
    names = lora_targets(module, [".*"])
    merged = dict(params)
    for path, ab in lora.items():
        name = names[path]
        merged[name] = params[name] + _delta(ab, alpha).to(params[name].dtype)
    return merged


@torch.no_grad()
def merge_lora(
    module: nn.Module, lora: dict[tuple[str, ...], dict[str, torch.Tensor]], alpha: float = 1.0
) -> nn.Module:
    """Fold the deltas into ``module``'s weights in place (zero-overhead inference); returns ``module``."""
    params = dict(module.named_parameters())
    names = lora_targets(module, [".*"])
    for path, ab in lora.items():
        w = params[names[path]]
        w.add_(_delta(ab, alpha).to(device=w.device, dtype=w.dtype))
    return module


def count_lora_params(lora: dict) -> int:
    return sum(int(ab["a"].numel() + ab["b"].numel()) for ab in lora.values())
