"""The plain reference one precision below bfloat16: every product's operands in float8 e4m3.

The control of a bf16 cell's check: the reference put in the program's place
and computed as an fp8 port of the chain would compute it.  Each convolution's
and linear layer's weight and input, and attention's queries, keys, values and
softmax probabilities, are rounded to float8 e4m3 with one scale a tensor (its
largest magnitude to 448, e4m3's largest finite value); the products accumulate
in float32 and everything else (normalisation, softmax, the sampler) stays as
the float32 reference computes it.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from perfbench.reference import resdiff as ref

E4M3_MAX = 448.0


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, returned in ``x``'s dtype."""
    scale = x.detach().abs().amax().clamp(min=torch.finfo(torch.float32).tiny) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def attention(q, k, v, scale, work=None):
    """``ref.attention`` with q, k, v and the softmax probabilities in e4m3."""
    if work is not None:
        work.attention.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
    q, k, v = e4m3(q), e4m3(k), e4m3(v)
    out = []
    for i in range(0, q.shape[1], ref.QUERY_BLOCK):
        s = torch.einsum("bnd,bmd->bnm", q[:, i:i + ref.QUERY_BLOCK], k) * scale
        out.append(torch.einsum("bnm,bmd->bnd", e4m3(torch.softmax(s, dim=-1)), v))
    return torch.cat(out, dim=1)


@contextlib.contextmanager
def fp8_products(*modules: nn.Module):
    """Within: ``modules``' convolutions and linear layers (their weights rounded now, their inputs at each call)
    and the reference's attention compute their products from e4m3 operands.  The weights stay rounded."""
    hooks = []
    for module in modules:
        for layer in module.modules():
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                with torch.no_grad():
                    layer.weight.copy_(e4m3(layer.weight))
                hooks.append(layer.register_forward_pre_hook(lambda _, args: (e4m3(args[0]), *args[1:])))
    exact = ref.attention
    ref.attention = attention
    try:
        yield
    finally:
        ref.attention = exact
        for h in hooks:
            h.remove()
