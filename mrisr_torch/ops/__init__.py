"""Tensor ops of the port; the kernels live in ``flash_attention`` and ``groupnorm``."""
from __future__ import annotations

import collections
import contextlib

from mrisr_torch._build import build_libraries
from mrisr_torch.ops import flash_attention, groupnorm


def _counted():
    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd,
        "flash_attention_bwd_dq": flash_attention.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": flash_attention.flash_attention_bwd_dkv,
        "group_norm_silu": groupnorm.group_norm_silu,
    }


def _recorded():
    return {
        "flash_attention_fwd": flash_attention.flash_attention_fwd,
        "flash_attention_bwd": flash_attention.flash_attention_bwd,
        "group_norm_silu": groupnorm.group_norm_silu,
    }


@contextlib.contextmanager
def recording_shapes():
    """Within the block, each kernel wrapper notes the arguments it launches its kernel at: yields
    ``{wrapper: Counter}`` keyed ``(b, n, m, d, dtype)`` for the flash pair (``flash_attention_bwd``
    launches dQ and dK/dV) and ``(shape, groups, eps, dtype)`` for ``group_norm_silu``.

    Recordings nest, each seeing every launch in its block.  As with the launch
    counts, a replay of a captured graph calls no wrapper and notes nothing.
    """
    seen = {name: collections.Counter() for name in _recorded()}
    for name, fn in _recorded().items():
        fn.shapes.append(seen[name])
    try:
        yield seen
    finally:
        for name, fn in _recorded().items():
            fn.shapes.remove(seen[name])


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
