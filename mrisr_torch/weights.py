"""Carry Flax parameters across to the port's modules.

The port names its submodules after the Flax auto-names (``conv_in``,
``ResnetBlockWithAttn_3``, ``ConvBlock_0``, ``GroupNorm_0``, ``Conv_0``,
``fd_spliter``, ...), so the mapping is a name-for-name walk of the tree:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* GroupNorm and LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* Embed ``embedding`` -> ``weight``;
* a parameter of the module itself (CLIP's ``position_embedding``) keeps its
  name and layout.

A module made of such modules walks the same way: SDXL's
``CLIPTextEncoderWithProjection`` takes the ``text_model`` and
``text_projection`` subtrees that ``convert-weights --model clip-proj``
writes, and the fused-tower and int8 forms use the UNet, ControlNet and
ResDiff trees unchanged.

Every leaf is used once; a leaf with no parameter, or a parameter with no
leaf, raises.  The tree holds numpy arrays; ``load_flax_checkpoint`` reads
one from a Flax ``.msgpack`` checkpoint with the port's own reader
(``utils/flax_msgpack.py``), so this package never imports flax.
``load_flax_train_checkpoint`` carries a whole training run across: the
parity harness's ``--ckpt`` file (``params``, ``ema``, ``opt_state``,
``step``), Adam's moments and count included, into a ``TrainState``.
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
    if key == "scale" and isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
        return "weight", arr
    if key == "bias" and isinstance(mod, (nn.Conv2d, nn.Linear, nn.GroupNorm, nn.LayerNorm)):
        return "bias", arr
    if key == "embedding" and isinstance(mod, nn.Embedding):
        return "weight", arr
    if key in mod._parameters:
        return key, arr
    raise KeyError(f"Flax leaf {path} has no counterpart in {type(mod).__name__}")


def _walk(mod: nn.Module, tree: Mapping, prefix: str, out: dict[str, np.ndarray]) -> None:
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, Mapping):
            child = mod._modules.get(key)
            if child is None:
                raise KeyError(f"Flax subtree {path} has no module in {type(mod).__name__}")
            _walk(child, sub, path + ".", out)
            continue
        pname, value = _target(mod, key, np.asarray(sub, dtype=np.float32), path)
        param = mod._parameters.get(pname)
        name = prefix + pname
        if param is None:
            raise KeyError(f"Flax leaf {path}: {type(mod).__name__} has no {pname}")
        if name in out:
            raise KeyError(f"parameter {name} filled twice")
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} does not fit {name} {tuple(param.shape)}")
        out[name] = value


def flax_named(module: nn.Module, tree: Mapping) -> dict[str, np.ndarray]:
    """``{parameter name: value in the port's layout}`` for a Flax tree shaped like ``module``'s parameters
    (``{"params": {...}}`` or the inner dict); ``module`` is not changed."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}
    _walk(module, tree, "", out)
    missing = sorted(name for name, _ in module.named_parameters() if name not in out)
    if missing:
        raise KeyError(f"parameters with no Flax leaf: {missing}")
    return out


def sd_unet_shape(tree: Mapping) -> dict:
    """``block_out_channels`` and ``layers_per_block`` of the SDUNet whose Flax tree ``tree`` is: one level a
    ``down_blocks_i``, its width the output channels of its first ResnetBlock2D's ``conv1``, and as many
    ResnetBlock2Ds a level as ``down_blocks_0`` holds ``resnets_j``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    levels = sum(k.startswith("down_blocks_") for k in tree)
    if not levels:
        raise KeyError("not an SDUNet tree: no down_blocks_*")
    channels = tuple(int(np.shape(tree[f"down_blocks_{i}"]["resnets_0"]["conv1"]["kernel"])[-1])
                     for i in range(levels))
    return {"block_out_channels": channels,
            "layers_per_block": sum(k.startswith("resnets_") for k in tree["down_blocks_0"])}


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Fill ``module``'s parameters from a Flax param tree of numpy arrays.

    ``tree`` is either ``{"params": {...}}`` (what ``Module.init`` returns) or
    the inner dict.
    """
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, value in flax_named(module, tree).items():
            params[name].copy_(torch.from_numpy(np.array(value)))


def load_flax_checkpoint(module: nn.Module, path: str | Path) -> dict:
    """Fill ``module`` from the EMA parameters of a Flax msgpack checkpoint (the weights a trained run
    serves).  Returns the whole checkpoint tree (``params``, ``ema``, ``opt_state``, ``step``)."""
    tree = read_msgpack(path)
    load_flax_params(module, tree["ema"])
    return tree


def _adam_moments(tree):
    """The first dict in ``tree`` (depth first) that holds Adam's ``mu`` and ``nu``; None if there is none."""
    if not isinstance(tree, Mapping):
        return None
    if "mu" in tree and "nu" in tree:
        return tree
    for sub in tree.values():
        found = _adam_moments(sub)
        if found is not None:
            return found
    return None


def load_flax_train_checkpoint(state, module: nn.Module, path: str | Path):
    """Copy a JAX training checkpoint (``{"params", "ema", "opt_state", "step"}``, as the parity harness's
    ``--ckpt`` writes it) into ``state`` (a ``TrainState`` over ``module``'s parameter names), in place, and
    return it: parameters, the EMA (when both have one), the step, and Adam's ``mu``, ``nu`` and ``count``
    when the file's optimizer state holds them (an older file without them leaves the optimizer state as it
    was)."""
    tree = read_msgpack(path)

    def copy(dst: dict, src: Mapping) -> None:
        with torch.no_grad():
            for name, value in flax_named(module, src).items():
                dst[name].copy_(torch.from_numpy(np.array(value)))

    copy(state.params, tree["params"])
    if state.ema_params is not None and "ema" in tree:
        copy(state.ema_params, tree["ema"])
    src, dst = _adam_moments(tree.get("opt_state")), _adam_moments(state.opt_state)
    if src is not None and dst is not None:
        copy(dst["mu"], src["mu"])
        copy(dst["nu"], src["nu"])
        dst["count"].copy_(torch.as_tensor(np.asarray(src["count"]).astype(np.int64)))
    state.step = int(tree["step"])
    return state


def flat_to_params(flat: Mapping, sep: str = "/") -> dict:
    """Flat ``{"a/b/c": array}`` -> the nested tree."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(sep)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def load_params_npz(path: str | Path) -> dict:
    """A Flax param tree from a converted ``.npz`` (flat ``"a/b/c"`` keys, as ``convert-weights`` writes
    them in both packages), for :func:`load_flax_params`."""
    with np.load(path) as z:
        return flat_to_params({k: z[k] for k in z.files})


def _source(mod: nn.Module, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """(Flax leaf name, value in the Flax layout) for parameter ``name`` of ``mod``: :func:`_target`'s
    inverse."""
    if name == "weight" and isinstance(mod, nn.Conv2d):
        return "kernel", arr.transpose(2, 3, 1, 0)
    if name == "weight" and isinstance(mod, nn.Linear):
        return "kernel", arr.T
    if name == "weight" and isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
        return "scale", arr
    if name == "weight" and isinstance(mod, nn.Embedding):
        return "embedding", arr
    return name, arr


def flax_params(module: nn.Module) -> dict:
    """The Flax param tree (float32 numpy, without the ``params`` root) that :func:`load_flax_params` would
    fill ``module`` from: its inverse."""
    tree: dict = {}
    for name, p in module._parameters.items():
        if p is not None:
            key, arr = _source(module, name, p.detach().float().cpu().numpy())
            tree[key] = arr
    for name, child in module._modules.items():
        sub = flax_params(child) if child is not None else {}
        if sub:
            tree[name] = sub
    return tree
