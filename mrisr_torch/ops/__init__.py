"""Tensor ops of the port; the two kernels live in ``flash_attention`` and ``groupnorm``."""
from __future__ import annotations

from mrisr_torch.ops import flash_attention, groupnorm


def build_kernels(device: str = "cuda") -> None:
    """Build the flash-attention library and compile the GroupNorm+SiLU kernels."""
    flash_attention.build(device)
    groupnorm.build(device)


def reset_launch_counts() -> None:
    flash_attention.flash_attention_fwd.launches = 0
    groupnorm.group_norm_silu.launches = 0


def launch_counts() -> dict[str, int]:
    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd.launches,
        "group_norm_silu": groupnorm.group_norm_silu.launches,
    }
