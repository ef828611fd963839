"""SDXL's two text towers and its prompt utilities (port of ``mrisr_tpu/models/sdxl_text.py``).

Two CLIP text towers (ViT-L 768 wide, and OpenCLIP bigG 1280 wide with a
bias-free text projection, transformers' ``CLIPTextModelWithProjection``);
each tower's penultimate hidden state, concatenated on channels, is the
prompt embedding, and the second tower's projected pooled output is the
pooled embedding.  Beside them SDXL's ``add_time_ids`` micro-conditioning
vector and the CFG dropout that swaps a share of the prompts for ``""``.

:class:`CLIPTextEncoderWithProjection` has the submodules ``text_model`` and
``text_projection``, so the Flax tree of ``convert-weights --model
clip-proj`` (``models/convert.py::flax_clip_text_with_projection``) loads
into it through ``weights.load_flax_params``.  The towers are modules holding
their weights, where the reference passes each one's parameters beside it;
the dropout draws from a ``torch.Generator`` where the reference takes a key.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from mrisr_torch.device import resolve_device
from mrisr_torch.models.clip_text import CLIPTextEncoder


class CLIPTextEncoderWithProjection(nn.Module):
    """A CLIP text tower and a bias-free linear projection of its pooled output (the EOS token's hidden
    state); bigG's sizes by default.  ``forward(ids) -> (hidden, projected pooled)`` (and the hidden states
    with ``output_hidden_states``)."""

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden: int = 1280,
        layers: int = 32,
        heads: int = 20,
        intermediate: int = 5120,
        max_positions: int = 77,
        eos_token_id: int = 49407,
        projection_dim: int = 1280,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.text_model = CLIPTextEncoder(vocab_size, hidden, layers, heads, intermediate, max_positions,
                                          eos_token_id, device=dev)
        with dev:
            self.text_projection = nn.Linear(hidden, projection_dim, bias=False)
        self.eval()

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False):
        out = self.text_model(input_ids, output_hidden_states=output_hidden_states)
        if output_hidden_states:
            hidden, pooled, states = out
            return hidden, self.text_projection(pooled), states
        hidden, pooled = out
        return hidden, self.text_projection(pooled)


def maybe_drop_prompts(
    prompts: Sequence[str],
    generator: torch.Generator | None = None,
    proportion_empty_prompts: float = 0.0,
    is_train: bool = True,
) -> list[str]:
    """CFG dropout: each prompt becomes ``""`` when its uniform draw from ``generator`` is below
    ``proportion_empty_prompts`` (training only; no generator, no dropout)."""
    if generator is None or proportion_empty_prompts <= 0.0 or not is_train:
        return list(prompts)
    drop = torch.rand((len(prompts),), generator=generator, device=generator.device).cpu()
    return ["" if float(d) < proportion_empty_prompts else p for d, p in zip(drop, prompts)]


def _ids(tokenizer, prompts: Sequence[str], encoder: nn.Module) -> torch.Tensor:
    device = next(encoder.parameters()).device
    return torch.as_tensor(np.asarray(tokenizer(list(prompts))["input_ids"]), device=device)


@torch.no_grad()
def encode_prompt_sdxl(
    encoders,  # (CLIPTextEncoder, CLIPTextEncoderWithProjection)
    tokenizers,  # one tokenizer a tower
    prompts: Sequence[str],
    generator: torch.Generator | None = None,
    proportion_empty_prompts: float = 0.0,
    is_train: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(prompt_embeds [B, 77, d1 + d2], pooled [B, projection_dim])``: each tower's penultimate hidden state
    (the last layer's input, before the final LayerNorm), concatenated on channels; the pooled output is the
    last tower's (the projection tower's)."""
    prompts = maybe_drop_prompts(prompts, generator, proportion_empty_prompts, is_train)
    embeds, pooled = [], None
    for enc, tok in zip(encoders, tokenizers):
        _, pooled, states = enc(_ids(tok, prompts, enc), output_hidden_states=True)
        embeds.append(states[-2])
    return torch.cat(embeds, dim=-1), pooled


def make_add_time_ids(
    original_size: tuple[int, int],
    crops_coords_top_left: tuple[int, int],
    target_size: tuple[int, int],
    batch: int = 1,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """SDXL's micro-conditioning vector ``[orig_h, orig_w, crop_top, crop_left, target_h, target_w]`` for each
    of ``batch`` samples: ``[batch, 6]``."""
    ids = torch.tensor([*original_size, *crops_coords_top_left, *target_size], dtype=dtype, device=device)
    return ids[None].expand(batch, 6)


def compute_embeddings_sdxl(
    encoders,
    tokenizers,
    prompts: Sequence[str],
    original_size: tuple[int, int] = (1024, 1024),
    crops_coords_top_left: tuple[int, int] = (0, 0),
    target_size: tuple[int, int] = (1024, 1024),
    generator: torch.Generator | None = None,
    proportion_empty_prompts: float = 0.0,
    is_train: bool = True,
) -> dict:
    """The UNet-ready SDXL conditioning: ``prompt_embeds``, ``text_embeds`` (pooled) and ``time_ids``."""
    prompt_embeds, pooled = encode_prompt_sdxl(encoders, tokenizers, prompts, generator, proportion_empty_prompts,
                                               is_train)
    time_ids = make_add_time_ids(original_size, crops_coords_top_left, target_size, prompt_embeds.shape[0],
                                 prompt_embeds.dtype, prompt_embeds.device)
    return {"prompt_embeds": prompt_embeds, "text_embeds": pooled, "time_ids": time_ids}


@torch.no_grad()
def encode_prompt_sd1x5(
    encoder: CLIPTextEncoder,
    tokenizer,
    prompts: Sequence[str],
    generator: torch.Generator | None = None,
    proportion_empty_prompts: float = 0.0,
    is_train: bool = True,
) -> torch.Tensor:
    """The single-tower SD1.5 variant: the final hidden state ``[B, 77, hidden]``."""
    prompts = maybe_drop_prompts(prompts, generator, proportion_empty_prompts, is_train)
    return encoder(_ids(tokenizer, prompts, encoder))[0]
