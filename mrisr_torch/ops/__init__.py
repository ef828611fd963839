"""Tensor ops of the port; the kernels live in ``flash_attention`` and ``groupnorm``."""
from __future__ import annotations

from mrisr_torch._build import build_libraries
from mrisr_torch.ops import flash_attention, groupnorm


def _counted():
    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd,
        "flash_attention_bwd_dq": flash_attention.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": flash_attention.flash_attention_bwd_dkv,
        "group_norm_silu": groupnorm.group_norm_silu,
    }


def build_kernels(device: str = "cuda") -> None:
    """Build every kernel library (one ``nvcc`` per source, all started together) and load them."""
    build_libraries(flash_attention.LIBRARIES + groupnorm.LIBRARIES, device)
    flash_attention.build(device)
    groupnorm.build(device)


def reset_launch_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches made through each kernel's wrapper (recording one into a CUDA graph counts as one).

    Replaying a captured graph calls no wrapper, so it adds nothing here;
    the kernels a replay ran are read from a trace of it.
    """
    return {name: fn.launches for name, fn in _counted().items()}
