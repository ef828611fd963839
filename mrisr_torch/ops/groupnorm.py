"""Fused GroupNorm + SiLU on NCHW: the CUDA kernel and its plain PyTorch version.

Port of ``mrisr_tpu/ops/groupnorm.py::_gn_silu_kernel`` (launched by
``_gn_silu_forward``): per (image, group) the mean and E[x^2] in fp32,
var = max(E[x^2] - mean^2, 0), rsqrt(var + eps), the affine folded into a
per-channel scale and bias, and y * sigmoid(y) written in the input dtype.
The kernel is ``csrc/group_norm_silu.cu``: one launch a call, one
thread-block cluster per (image, group) span, each CTA keeping its slice of
the span in shared memory, so x is read once (the design and its bound are
described in the source).  :func:`gn_plan` cuts the spans into slices.

Gradient.  ``group_norm_silu`` is a ``torch.autograd.Function``: its forward
is the kernel, its backward the exact composition (autograd through
:func:`group_norm_silu_plain` on the saved input), as the reference's
``fused_group_norm_silu`` has a ``custom_vjp`` over
``group_norm_silu_reference`` and no backward kernel.  Where no gradient is
needed the kernel is launched without the autograd function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mrisr_torch._build import build_libraries, load_library
from mrisr_torch.device import device_ctx

# The kernel's constants (``csrc/group_norm_silu.cu``; a test holds the two to each other).
GN_MAX_CLUSTER = 8  # CTAs a cluster, at most
GN_SLICE_TARGET = 64 * 1024  # bytes of a CTA's slice the plan aims at
GN_MAX_SLICE_BYTES = 224 * 1024  # bytes of a slice a CTA may keep in shared memory
GN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LIBRARIES = ("group_norm_silu",)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_L, _L] + [_I] * 5 + [_L, _I, _I, ctypes.c_float, _P]
_FN = None


def group_norm_silu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """GroupNorm in fp32, then SiLU, cast back to ``x.dtype``.

    ``torch.group_norm`` is ``F.group_norm`` without its batch check, which
    refuses a group of one element (whose GroupNorm is its bias: the tiny SD
    configurations have such groups at bs 1).
    """
    y = torch.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return F.silu(y).to(x.dtype)


class GnPlan(NamedTuple):
    """How the kernel cuts the (image, group) spans of one shape."""

    span: int  # elements of a span: (C / groups) * H * W
    cluster: int  # CTAs a span: 1, 2, 4 or 8
    chunk: int  # elements a CTA (the last of a cluster may have fewer)
    resident: bool  # the slice is kept in shared memory (else x is read twice)
    vec: bool  # 16-byte units: H * W a multiple of 16 bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def gn_plan(shape: tuple[int, ...], groups: int, elem_size: int, target: int = GN_SLICE_TARGET) -> GnPlan:
    """The fewest CTAs a span, 1 to ``GN_MAX_CLUSTER``, that keep a slice at ``target`` bytes or under
    (or the most); slices in whole 16-byte units where H*W allows; a slice is kept in shared memory
    when it takes ``GN_MAX_SLICE_BYTES`` or fewer."""
    _, c, h, w = shape
    span = c // groups * h * w
    vec = (h * w * elem_size) % 16 == 0
    unit = 16 // elem_size if vec else 1
    cluster = 1
    while cluster < GN_MAX_CLUSTER and span * elem_size > cluster * target:
        cluster *= 2
    chunk = _cdiv(_cdiv(span, cluster), unit) * unit
    return GnPlan(span, cluster, chunk, chunk * elem_size <= GN_MAX_SLICE_BYTES, vec)


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = load_library("group_norm_silu").mrisr_group_norm_silu
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _FN = fn
    return _FN


def _launch(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor (no counting)."""
    if x.dtype not in GN_DTYPES:
        raise TypeError(f"group_norm_silu kernel takes float32, bfloat16 or float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu kernel needs a contiguous NCHW tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"weight and bias must be {x.dtype}, got {weight.dtype}, {bias.dtype}")
    b, c, h, w = x.shape
    plan = gn_plan(tuple(x.shape), groups, x.element_size())
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with device_ctx(x.device):
        err = _kernel_fn()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), b * groups, plan.span, h * w,
            c // groups, groups, GN_DTYPES[x.dtype], plan.cluster, plan.chunk,
            int(plan.resident), int(plan.vec and x.data_ptr() % 16 == 0), float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm_silu kernel launch failed: cudaError {err}")
    return y


def _forward(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    y = _launch(x, weight, bias, groups, eps)
    group_norm_silu.launches += 1
    for seen in group_norm_silu.shapes:  # the recordings open (``ops.recording_shapes``)
        seen[(tuple(x.shape), groups, eps, x.dtype)] += 1
    return y


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: the kernel.  Backward: the exact composition, fp32 inside."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y = _forward(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        # The range names this composition in a profiler trace.
        with torch.profiler.record_function("group_norm_silu_backward"), torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, weight, bias)]
            y = group_norm_silu_plain(*leaves, ctx.groups, ctx.eps)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(leaves, need) if n], dy))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def group_norm_silu(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """SiLU(GroupNorm(x)) on NCHW ``x``; fp32 statistics, output in ``x.dtype``.

    On a CPU tensor it runs :func:`group_norm_silu_plain`; on a CUDA tensor it
    launches the kernel or raises.  Differentiable on both.
    """
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu takes NCHW, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight and bias must have shape ({c},)")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNormSiLU.apply(x, weight, bias, groups, eps)
    return _forward(x, weight, bias, groups, eps)


group_norm_silu.launches = 0
group_norm_silu.shapes = []


def build(device: str = "cuda") -> None:
    """Compile (if needed) and load the kernel library."""
    build_libraries(LIBRARIES, device)
    _kernel_fn()
