"""Carry Flax parameters across to the port's modules.

The port names its submodules after the Flax auto-names (``conv_in``,
``ResnetBlockWithAttn_3``, ``ConvBlock_0``, ``GroupNorm_0``, ``Conv_0``,
``fd_spliter``, ...), so the mapping is a name-for-name walk of the tree:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``.

Every leaf is used once; a leaf with no parameter, or a parameter with no
leaf, raises.  The tree holds numpy arrays; ``load_flax_checkpoint`` reads
one from a Flax ``.msgpack`` checkpoint with the port's own reader
(``utils/flax_msgpack.py``), so this package never imports flax.
"""
from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from mrisr_torch.utils.flax_msgpack import read_msgpack


def _target(mod: nn.Module, key: str, arr: np.ndarray, path: str) -> tuple[str, np.ndarray]:
    """(parameter name, value in the port's layout) for Flax leaf ``key``."""
    if key == "kernel" and isinstance(mod, nn.Conv2d):
        return "weight", arr.transpose(3, 2, 0, 1)
    if key == "kernel" and isinstance(mod, nn.Linear):
        return "weight", arr.T
    if key == "scale" and isinstance(mod, nn.GroupNorm):
        return "weight", arr
    if key == "bias" and isinstance(mod, (nn.Conv2d, nn.Linear, nn.GroupNorm)):
        return "bias", arr
    raise KeyError(f"Flax leaf {path} has no counterpart in {type(mod).__name__}")


def _walk(mod: nn.Module, tree: Mapping, prefix: str, used: set[str]) -> None:
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            child = mod._modules.get(key)
            if child is None:
                raise KeyError(f"Flax subtree {path} has no module in {type(mod).__name__}")
            _walk(child, sub, path + ".", used)
            continue
        pname, value = _target(mod, key, np.asarray(sub, dtype=np.float32), path)
        param = mod._parameters.get(pname)
        name = prefix + pname
        if param is None:
            raise KeyError(f"Flax leaf {path}: {type(mod).__name__} has no {pname}")
        if name in used:
            raise KeyError(f"parameter {name} filled twice")
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} does not fit {name} {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value)))
        used.add(name)


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Fill ``module``'s parameters from a Flax param tree of numpy arrays.

    ``tree`` is either ``{"params": {...}}`` (what ``Module.init`` returns) or
    the inner dict.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    used: set[str] = set()
    _walk(module, tree, "", used)
    missing = sorted(name for name, _ in module.named_parameters() if name not in used)
    if missing:
        raise KeyError(f"parameters with no Flax leaf: {missing}")


def load_flax_checkpoint(module: nn.Module, path: str | Path) -> dict:
    """Fill ``module`` from the EMA parameters of a Flax msgpack checkpoint (the weights a trained run
    serves).  Returns the whole checkpoint tree (``params``, ``ema``, ``opt_state``, ``step``)."""
    tree = read_msgpack(path)
    load_flax_params(module, tree["ema"])
    return tree
