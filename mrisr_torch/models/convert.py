"""Diffusers and transformers state dicts -> the port's modules and Flax-layout trees (port of
``mrisr_tpu/models/convert.py``).

Two forms of the same conversion:

* **state dicts for the port's modules** (:func:`convert_sd_unet`,
  :func:`convert_controlnet`, :func:`convert_vae`, :func:`convert_clip_text`),
  for ``module.load_state_dict`` (strict).  The port's modules are torch
  modules with the reference's Flax names, so a tensor keeps its layout and
  only its key changes;
* **Flax-layout trees** (:data:`CONVERTERS`: ``vae``, ``unet``,
  ``controlnet``, ``clip``, ``clip-proj``), the reference's own numpy
  converters: conv kernels ``[kh, kw, in, out]``, Dense kernels ``[in, out]``,
  norm ``scale`` / ``bias``, names ``a_0/b``.  ``convert-weights`` saves them
  with :func:`save_params_npz`, the ``.npz`` that ``train-latent
  --weights-dir`` reads in both packages.

Key rules, both forms:

* a module-list index joins its list's name (``down_blocks.0.resnets.1`` ->
  ``down_blocks_0.resnets_1``, ``ff.net.0`` -> ``ff.net_0``);
* ``to_out.0`` (a Sequential with dropout) is ``to_out``;
* the VAE's pre-0.15 attention names (``query``, ``key``, ``value``,
  ``proj_attn``) are ``to_q``, ``to_k``, ``to_v``, ``to_out``, and
  projections stored as 1x1 convs become Linear weights;
* CLIP's ``text_model.embeddings.*`` and ``encoder.layers.{i}`` are
  ``token_embedding``, ``position_embedding`` and ``layers_{i}``.

:func:`export_diffusers_tree` goes the other way: a port module (through
``weights.flax_params``) or a Flax tree -> the diffusers-named state dict.
Tensors are float32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mrisr_torch.weights import flat_to_params, flax_params, load_params_npz  # noqa: F401  (re-exported)

_VAE_ATTN_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out"}
_VAE_ATTN_PROJ = {"to_q", "to_k", "to_v", "to_out"}


def _tensor(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(w, dtype=np.float32))


def _t(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def _fix_vae_keys(sd: Mapping, as_array) -> dict:
    """Legacy VAE attention names -> the new ones; 1x1-conv projections -> Linear weights."""
    fixed = {}
    for key, w in sd.items():
        parts = [_VAE_ATTN_LEGACY.get(p, p) for p in key.split(".")]
        w = as_array(w)
        if w.ndim == 4 and any(p in _VAE_ATTN_PROJ for p in parts):
            w = w[:, :, 0, 0]  # [out, in, 1, 1] conv projection -> Linear
        fixed[".".join(parts)] = w
    return fixed


# ---------------------------------------------------------------------------
# State dicts for the port's modules
# ---------------------------------------------------------------------------


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


def port_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """A diffusers state dict under the port's parameter names (float32 tensors)."""
    return {port_key(k): _tensor(w) for k, w in sd.items() if not k.endswith("num_batches_tracked")}


def convert_sd_unet(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``UNet2DConditionModel`` state dict -> ``SDUNet``'s."""
    return port_state_dict(sd)


def convert_controlnet(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``ControlNetModel`` state dict -> ``ControlNet``'s."""
    return port_state_dict(sd)


def convert_vae(sd: Mapping) -> dict[str, torch.Tensor]:
    """diffusers ``AutoencoderKL`` state dict (new or pre-0.15 attention names) -> ``AutoencoderKL``'s."""
    return port_state_dict(_fix_vae_keys(sd, _tensor))


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


# ---------------------------------------------------------------------------
# Flax-layout trees (numpy), as the reference's convert-weights writes them
# ---------------------------------------------------------------------------


def _linear(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def flax_clip_text(sd: Mapping, num_layers: int = 12) -> dict:
    """transformers ``CLIPTextModel`` state dict -> the ``CLIPTextEncoder`` Flax tree."""
    p = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    params: dict = {
        "token_embedding": {"embedding": _t(sd[f"{p}embeddings.token_embedding.weight"])},
        "position_embedding": _t(sd[f"{p}embeddings.position_embedding.weight"]),
        "final_layer_norm": _norm(sd, f"{p}final_layer_norm"),
    }
    for i in range(num_layers):
        lp = f"{p}encoder.layers.{i}"
        params[f"layers_{i}"] = {
            "layer_norm1": _norm(sd, f"{lp}.layer_norm1"),
            "layer_norm2": _norm(sd, f"{lp}.layer_norm2"),
            "self_attn": {name: _linear(sd, f"{lp}.self_attn.{name}")
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": _linear(sd, f"{lp}.mlp.fc1"), "fc2": _linear(sd, f"{lp}.mlp.fc2")},
        }
    return {"params": params}


def flax_clip_text_with_projection(sd: Mapping, num_layers: int = 32) -> dict:
    """transformers ``CLIPTextModelWithProjection`` (SDXL's second tower) -> its Flax tree."""
    inner = flax_clip_text(sd, num_layers)["params"]
    return {"params": {"text_model": inner, "text_projection": {"kernel": _t(sd["text_projection.weight"]).T}}}


def convert_diffusers_tree(sd: Mapping) -> dict:
    """A diffusers state dict -> nested Flax tree under :func:`port_key`'s names (``a.0.b`` -> ``a_0/b``,
    ``to_out.0`` -> ``to_out``, ``net.{i}`` -> ``net_{i}``); a weight's orientation by its rank (4-D conv,
    2-D Dense, else a norm's ``scale``)."""
    tree: dict = {}
    for key, w in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        *mods, leaf = port_key(key).split(".")
        w = _t(w)
        if leaf == "weight":
            node = {"kernel": w.transpose(2, 3, 1, 0)} if w.ndim == 4 else {"kernel": w.T} if w.ndim == 2 else {
                "scale": w}
        else:
            node = {leaf: w}
        cur = tree
        for m in mods:
            cur = cur.setdefault(m, {})
        cur.update(node)
    return tree


def flax_sd_unet(sd: Mapping) -> dict:
    return {"params": convert_diffusers_tree(sd)}


def flax_controlnet(sd: Mapping) -> dict:
    return {"params": convert_diffusers_tree(sd)}


def flax_vae(sd: Mapping) -> dict:
    """diffusers ``AutoencoderKL`` state dict (new or pre-0.15 attention names) -> its Flax tree."""
    return {"params": convert_diffusers_tree(_fix_vae_keys(sd, _t))}


# ``convert-weights --model`` -> converter.
CONVERTERS = {
    "vae": flax_vae,
    "unet": flax_sd_unet,
    "controlnet": flax_controlnet,
    "clip": flax_clip_text,
    "clip-proj": flax_clip_text_with_projection,
}


def params_to_flat(params: Mapping, sep: str = "/") -> dict:
    """Nested tree -> flat ``{"a/b/c": array}``."""
    out: dict = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = np.asarray(v)

    walk(params, "")
    return out


def save_params_npz(path, params: Mapping) -> None:
    """The tree as a compressed ``.npz`` of flat ``"a/b/c"`` keys (the reference's format)."""
    np.savez_compressed(path, **params_to_flat(params))


# ---------------------------------------------------------------------------
# Flax path -> diffusers key
# ---------------------------------------------------------------------------

# Flax module names whose trailing _{i} is a diffusers ModuleList index (``name.{i}`` in a state dict).
# Names like ``linear_1`` / ``norm1`` / ``fc1`` keep their spelling in diffusers.
_LIST_MODULES = {"down_blocks", "up_blocks", "resnets", "attentions", "downsamplers", "upsamplers",
                 "transformer_blocks", "net", "blocks", "controlnet_down_blocks"}
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_path_to_diffusers_key(path: tuple[str, ...]) -> str:
    """``('down_blocks_0', 'resnets_1', 'norm1', 'scale')`` -> ``'down_blocks.0.resnets.1.norm1.weight'``,
    the inverse of :func:`convert_diffusers_tree`'s names."""
    *mods, leaf = path
    out: list[str] = []
    for m in mods:
        stem, _, idx = m.rpartition("_")
        if idx.isdigit() and stem in _LIST_MODULES:
            out.extend([stem, idx])
        else:
            out.append(m)
        if m == "to_out":
            out.append("0")  # diffusers wraps the output projection in a Sequential
    return ".".join(out + [_LEAF_TO_TORCH.get(leaf, leaf)])


def flax_leaf_to_torch(leaf_name: str, w: np.ndarray) -> np.ndarray:
    """One Flax leaf in the torch checkpoint's orientation."""
    w = np.asarray(w)
    if leaf_name == "kernel":
        return w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    return w


def export_diffusers_tree(params) -> dict:
    """A port module, or a Flax tree (with or without its ``params`` root), -> the flat diffusers-named
    state dict (numpy), in the tree's sorted leaf order."""
    if isinstance(params, torch.nn.Module):
        params = flax_params(params)
    out: dict = {}

    def walk(node, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                names = path + (k,)
                if names[0] == "params":
                    names = names[1:]
                out[flax_path_to_diffusers_key(names)] = flax_leaf_to_torch(names[-1], v)

    walk(params, ())
    return out
