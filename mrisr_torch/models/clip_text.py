"""CLIP text encoder, the ViT-L/14 text tower of SD1.5 (port of ``mrisr_tpu/models/clip_text.py``).

Token and learned position embeddings, a pre-LayerNorm transformer (eps
1e-5) with a causal mask and quick-GELU MLPs, a final LayerNorm; the pooled
output is the hidden state at the first EOS token.  ``HashTokenizer`` is the
reference's deterministic stand-in tokenizer; ``default_tokenizer`` uses the
CLIP BPE tokenizer when a ``vocab.json`` and ``merges.txt`` are given.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch
from torch import nn

from mrisr_torch.device import resolve_device


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.hidden // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd**-0.5)
        logits = torch.einsum("bhnd,bhmd->bhnm", q, split(self.k_proj(x))) + mask
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", w, split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, n, self.hidden))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp = CLIPMLP(hidden, intermediate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids [B, N]) -> (hidden [B, N, hidden], pooled [B, hidden])``; built on ``device``
    (CUDA by default)."""

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        intermediate: int = 3072,
        max_positions: int = 77,
        eos_token_id: int = 49407,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        super().__init__()
        self.layers, self.eos_token_id = layers, eos_token_id
        with dev:
            self.token_embedding = nn.Embedding(vocab_size, hidden)
            self.position_embedding = nn.Parameter(0.01 * torch.randn(max_positions, hidden))
            for i in range(layers):
                self.add_module(f"layers_{i}", CLIPEncoderLayer(hidden, heads, intermediate))
            self.final_layer_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.eval()

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False):
        ids = input_ids.long()
        b, n = ids.shape
        x = self.token_embedding(ids) + self.position_embedding[None, :n]
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)[None, None]
        hidden_states = []
        for i in range(self.layers):
            hidden_states.append(x)
            x = getattr(self, f"layers_{i}")(x, causal)
        hidden_states.append(x)
        x = self.final_layer_norm(x)
        eos = (ids == self.eos_token_id).int().argmax(dim=-1)  # the first EOS of each row
        pooled = x[torch.arange(b, device=x.device), eos]
        if output_hidden_states:
            return x, pooled, hidden_states
        return x, pooled


class HashTokenizer:
    """Deterministic stand-in tokenizer with the CLIP call signature (words hashed to ids; not CLIP's
    vocabulary): for hermetic runs and fixed-prompt flows whose embedding is cached."""

    model_max_length = 77
    bos_token_id = 49406
    eos_token_id = 49407

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding="max_length", max_length=None, truncation=True, **_):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for t in texts:
            ids = [self.bos_token_id]
            for w in t.lower().split():
                ids.append(int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2))
            ids = ids[: max_length - 1] + [self.eos_token_id]
            ids += [self.eos_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": np.asarray(out, np.int32)}


def default_tokenizer(vocab_dir=None):
    """The CLIP BPE tokenizer when ``vocab_dir`` holds ``vocab.json`` and ``merges.txt``, else
    :class:`HashTokenizer`."""
    if vocab_dir is not None:
        p = Path(vocab_dir)
        if (p / "vocab.json").exists() and (p / "merges.txt").exists():
            from mrisr_torch.models.tokenizer import CLIPBPETokenizer

            return CLIPBPETokenizer.from_pretrained(p)
    return HashTokenizer()


@torch.no_grad()
def get_fixed_prompt_embeds(
    encoder: CLIPTextEncoder, tokenizer=None, prompt: str = "medical mri scan, high resolution"
) -> torch.Tensor:
    """One frozen prompt embedding ``[1, 77, hidden]`` on the encoder's device."""
    tokenizer = tokenizer or default_tokenizer()
    device = encoder.token_embedding.weight.device
    ids = torch.as_tensor(np.asarray(tokenizer(prompt)["input_ids"]), device=device)
    return encoder(ids)[0]
