"""Mixed-precision policy (port of ``mrisr_tpu/train/precision.py``).

fp32 master parameters and optimizer state; with a bf16 policy the loss
function casts the *whole* parameter tree and the input to bfloat16 for the
forward and backward, and the cast's own gradient carries the gradients back
to the fp32 masters.  (``torch.autocast`` is a different thing: it picks a
dtype per op and keeps the norms in fp32.)  No loss scaling: bf16 has fp32's
exponent range.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def _cast_floating(tree, dtype: torch.dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    return tree


@dataclass(frozen=True)
class Policy:
    """The master parameters are always float32; only the compute dtype varies."""

    compute_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)


def get_policy(name: str | None) -> Policy:
    """'bfloat16'/'bf16'/'mixed' -> bf16 compute; None/'float32'/'fp32'/'none' -> pure fp32."""
    if name in (None, "float32", "fp32", "none"):
        return Policy()
    if name in ("bfloat16", "bf16", "mixed"):
        return Policy(compute_dtype=torch.bfloat16)
    raise ValueError(f"unknown precision policy {name!r}")
