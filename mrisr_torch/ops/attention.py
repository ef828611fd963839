"""Spatial attention ops (port of ``mrisr_tpu/ops/attention.py``).

All inputs are ``[B, N, D]`` (already head-split if multi-head).  Dispatch
follows the reference: sequences of ``CHUNK_THRESHOLD`` tokens or more go to
``flash_attention`` (the kernels on a CUDA tensor, their plain q-chunked
version on a CPU tensor; differentiable on both); shorter ones use dense
attention on either device.
"""
from __future__ import annotations

import math

import torch

from mrisr_torch.ops.flash_attention import flash_attention

CHUNK_THRESHOLD = 4096
DEFAULT_CHUNK = 512


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    logits = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnm,bmd->bnd", w, v)


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, chunk: int = DEFAULT_CHUNK
) -> torch.Tensor:
    """Exact attention in q chunks, dense when ``n`` is no multiple of ``chunk``.

    The reference's CPU path; the port keeps it as a yardstick for its tests
    and runs :func:`flash_attention` instead.
    """
    n = q.shape[1]
    if n % chunk != 0:
        return dense_attention(q, k, v, scale)
    return torch.cat(
        [dense_attention(q[:, i : i + chunk], k, v, scale) for i in range(0, n, chunk)], dim=1
    )


def _attend(q, k, v, scale):
    if q.shape[1] >= CHUNK_THRESHOLD:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    return dense_attention(q, k, v, scale)


def spatial_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int = 1
) -> torch.Tensor:
    """Multi-head attention over flattened spatial tokens ``[B, N, C]``."""
    b, n, c = q.shape
    h = num_heads
    dh = c // h

    def split(x):
        return x.reshape(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh)

    out = _attend(split(q), split(k), split(v), 1.0 / math.sqrt(dh))
    return out.reshape(b, h, n, dh).transpose(1, 2).reshape(b, n, c)


def cross_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-head cross-attention ``[B, N, C]`` with 1/sqrt(C) scaling."""
    return _attend(q, k, v, 1.0 / math.sqrt(q.shape[-1]))
