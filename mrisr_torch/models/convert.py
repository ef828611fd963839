"""Diffusers and transformers state dicts -> the port's modules (port of ``mrisr_tpu/models/convert.py``).

The port's modules are torch modules with the reference's Flax names, so a
checkpoint's tensors keep their layout and only their keys change:

* a module-list index joins its list's name (``down_blocks.0.resnets.1`` ->
  ``down_blocks_0.resnets_1``, ``ff.net.0`` -> ``ff.net_0``);
* ``to_out.0`` (a Sequential with dropout) is ``to_out``;
* the VAE's pre-0.15 attention names (``query``, ``key``, ``value``,
  ``proj_attn``) are ``to_q``, ``to_k``, ``to_v``, ``to_out``, and
  projections stored as 1x1 convs become Linear weights;
* CLIP's ``text_model.embeddings.*`` and ``encoder.layers.{i}`` are
  ``token_embedding``, ``position_embedding`` and ``layers_{i}``.

Each converter returns a state dict for ``module.load_state_dict`` (strict:
a key the module lacks, or a parameter with no key, raises).  Tensors are
float32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_VAE_ATTN_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out"}
_VAE_ATTN_PROJ = {"to_q", "to_k", "to_v", "to_out"}


def _tensor(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(w, dtype=np.float32))


def port_key(key: str) -> str:
    """A diffusers state-dict key -> the port's parameter name."""
    *mods, leaf = key.split(".")
    if len(mods) >= 2 and mods[-2] == "to_out" and mods[-1] == "0":
        mods = mods[:-1]
    merged: list[str] = []
    for m in mods:
        if m.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{m}"
        else:
            merged.append(m)
    return ".".join(merged + [leaf])


def convert_diffusers_tree(sd: Mapping) -> dict[str, torch.Tensor]:
    return {port_key(k): _tensor(w) for k, w in sd.items() if not k.endswith("num_batches_tracked")}


def convert_sd_unet(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``UNet2DConditionModel`` state dict -> ``SDUNet``'s."""
    return convert_diffusers_tree(sd)


def convert_controlnet(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``ControlNetModel`` state dict -> ``ControlNet``'s."""
    return convert_diffusers_tree(sd)


def convert_vae(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``AutoencoderKL`` state dict (new or pre-0.15 attention names) -> ``AutoencoderKL``'s."""
    fixed = {}
    for key, w in sd.items():
        parts = [_VAE_ATTN_LEGACY.get(p, p) for p in key.split(".")]
        w = _tensor(w)
        if w.ndim == 4 and any(p in _VAE_ATTN_PROJ for p in parts):
            w = w[:, :, 0, 0]  # [out, in, 1, 1] conv projection -> Linear
        fixed[".".join(parts)] = w
    return convert_diffusers_tree(fixed)


def convert_clip_text(sd: Mapping, num_layers: int = 12) -> dict[str, torch.Tensor]:
    """transformers ``CLIPTextModel`` state dict -> ``CLIPTextEncoder``'s."""
    p = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    out = {
        "token_embedding.weight": _tensor(sd[f"{p}embeddings.token_embedding.weight"]),
        "position_embedding": _tensor(sd[f"{p}embeddings.position_embedding.weight"]),
        "final_layer_norm.weight": _tensor(sd[f"{p}final_layer_norm.weight"]),
        "final_layer_norm.bias": _tensor(sd[f"{p}final_layer_norm.bias"]),
    }
    for i in range(num_layers):
        lp = f"{p}encoder.layers.{i}."
        out.update({f"layers_{i}.{k[len(lp):]}": _tensor(w) for k, w in sd.items() if k.startswith(lp)})
    return out
