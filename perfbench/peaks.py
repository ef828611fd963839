"""The H100's published peaks and the arithmetic of a kernel's least time.

NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 495 TFLOP/s in TF32, 67
TFLOP/s in float32 outside them, 3.35 TB/s of HBM3.  Work the configuration
states in exact float32 is held to 3xTF32 on the tensor cores, three TF32
passes a product (165 TFLOP/s): the fastest fp32-accurate form on this card,
the one the port's fp32 kernels use.  A card set below 700 W reaches less;
the benchmark prints the power limit beside every run.

``flash_fwd_work``, ``flash_bwd_work`` and ``gn_silu_work`` are the
operations and bytes a call needs, from its shape alone (each input byte read once, each output byte
written once), as the port's kernel table counts them.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 495e12 / 3.0}
PEAK_BYTES = 3.35e12
# Float32 arithmetic outside the tensor cores (GroupNorm+SiLU's statistics and activation).
PEAK_FP32_SIMT = 67e12
ELEMENT_BYTES = {"bf16": 2, "fp16": 2, "fp32": 4, "tf32": 4}


def least_seconds(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """The least time of a call: the larger of its bytes over the bandwidth and its operations over
    ``peak_ops``."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)


def flash_fwd_work(b: int, n: int, m: int, d: int, precision: str) -> tuple[float, float]:
    """(operations, bytes) of non-causal attention of ``b`` rows of ``n`` queries over ``m`` keys of width
    ``d``: QK^T and PV, 4bnmd; Q, K, V read once, O written once, and the float32 log-sum-exp a row."""
    size = ELEMENT_BYTES[precision]
    return 4.0 * b * n * m * d, (2 * b * n * d + 2 * b * m * d) * size + 4 * b * n


def flash_fwd_seconds(b: int, n: int, m: int, d: int, precision: str) -> float:
    ops, n_bytes = flash_fwd_work(b, n, m, d, precision)
    return least_seconds(n_bytes, ops, PEAK_FLOPS[precision])


def flash_bwd_work(b: int, n: int, m: int, d: int, precision: str) -> list[tuple[float, float]]:
    """(operations, bytes) of the backward's two kernels: dQ (recomputing P, dP = dO V^T, dQ = dS K: 6bnmd; Q,
    dO, dQ, K, V and the row statistics) and dK/dV (S, P, dV = P^T dO, dP, dK = dS^T Q: 8bnmd; Q, dO, K, V,
    dK, dV and the row statistics), each byte once."""
    size = ELEMENT_BYTES[precision]
    return [(6.0 * b * n * m * d, (3 * b * n * d + 2 * b * m * d) * size + 8 * b * n),
            (8.0 * b * n * m * d, (2 * b * n * d + 4 * b * m * d) * size + 8 * b * n)]


def flash_bwd_seconds(b: int, n: int, m: int, d: int, precision: str) -> float:
    return sum(least_seconds(n_bytes, ops, PEAK_FLOPS[precision])
               for ops, n_bytes in flash_bwd_work(b, n, m, d, precision))


def gn_silu_work(shape: tuple[int, ...], precision: str, param_precision: str | None = None) -> tuple[float, float]:
    """(operations, bytes) of GroupNorm+SiLU on NCHW ``shape``: x read once, y written once, the affine's
    two vectors; about ten float32 operations an element (statistics, normalisation, SiLU)."""
    numel = 1
    for s in shape:
        numel *= s
    c = shape[1]
    n_bytes = 2 * numel * ELEMENT_BYTES[precision] + 2 * c * ELEMENT_BYTES[param_precision or precision]
    return 10.0 * numel, n_bytes


def gn_silu_seconds(shape: tuple[int, ...], precision: str, param_precision: str | None = None) -> float:
    ops, n_bytes = gn_silu_work(shape, precision, param_precision)
    return least_seconds(n_bytes, ops, PEAK_FP32_SIMT)
