"""Fused GroupNorm + SiLU on NCHW: Triton kernel and its plain PyTorch version.

Port of ``mrisr_tpu/ops/groupnorm.py::_gn_silu_kernel`` (launched by
``_gn_silu_forward``): per (image, group) the mean and E[x^2] in fp32,
var = max(E[x^2] - mean^2, 0), rsqrt(var + eps), the affine folded into a
per-channel scale and bias, and y * sigmoid(y) written in the input dtype.

Design.  The TPU kernel keeps a whole image resident in VMEM and reads it
once.  One 256^2 x 96 bf16 image is 12.6 MB, far beyond the 227 KB of shared
memory an H100 block has, so the port runs two passes.  In NCHW each
(image, group) is one contiguous span: a stats pass splits every span over
several programs (one program per group would leave the 132 SMs idle: the
serving chain has 8 x 16 = 128 groups) and writes fp32 partial sums; a second
pass reduces those partials and normalizes + applies SiLU.  The second read
of x may hit the 50 MB L2.

Bound.  Bytes: one read and one write of x.  The largest call on the serving
chain, 8 x 96 x 256^2 bf16, moves 201 MB, about 60 us at 3.35 TB/s; all 29
calls of one UNet forward at bs 8 move ~1.1 GB, about 0.33 ms.

Gradient.  ``group_norm_silu`` is a ``torch.autograd.Function``: its forward
is the kernel, its backward the exact composition (autograd through
:func:`group_norm_silu_plain` on the saved input), as the reference's
``fused_group_norm_silu`` has a ``custom_vjp`` over
``group_norm_silu_reference`` and no backward kernel.
"""
from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from mrisr_torch._build import BUILD_ROOT
from mrisr_torch.device import resolve_device

BLOCK = 2048  # elements per inner step of a program
MAX_SPLITS = 64  # programs per (image, group) span, at most
PROGRAMS_PER_SM = 4

_KERNELS = None


def group_norm_silu_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """``F.group_norm`` in fp32, then SiLU, cast back to ``x.dtype``."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return F.silu(y).to(x.dtype)


def _triton_kernels():
    """Define the Triton kernels once, on first use (``triton`` is imported here)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats_kernel(x_ptr, part_ptr, group_numel, chunk, n_splits, BLOCK: tl.constexpr):
        bg = tl.program_id(0)
        s = tl.program_id(1)
        base = x_ptr + bg.to(tl.int64) * group_numel
        start = s * chunk
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, chunk, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            xv = tl.load(base + idx, mask=idx < group_numel, other=0.0).to(tl.float32)
            acc1 += xv
            acc2 += xv * xv
        out = part_ptr + (bg * n_splits + s) * 2
        tl.store(out, tl.sum(acc1, axis=0))
        tl.store(out + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def gn_silu_apply_kernel(
        x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, group_numel, hw, cg, groups, chunk, n_splits,
        inv_count, eps, NS: tl.constexpr, BLOCK: tl.constexpr,
    ):
        bg = tl.program_id(0)
        s = tl.program_id(1)
        ks = tl.arange(0, NS)
        pm = ks < n_splits
        parts = part_ptr + (bg * n_splits + ks) * 2
        s1 = tl.sum(tl.load(parts, mask=pm, other=0.0), axis=0)
        s2 = tl.sum(tl.load(parts + 1, mask=pm, other=0.0), axis=0)
        mean = s1 * inv_count
        var = tl.maximum(s2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        c0 = (bg % groups) * cg
        base = bg.to(tl.int64) * group_numel
        start = s * chunk
        for off in range(0, chunk, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            m = idx < group_numel
            c = c0 + idx // hw
            w = tl.load(w_ptr + c, mask=m, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + c, mask=m, other=0.0).to(tl.float32)
            xv = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            sc = w * rstd
            yv = xv * sc + (b - mean * sc)
            out = yv / (1.0 + tl.exp(-yv))
            tl.store(y_ptr + base + idx, out.to(y_ptr.dtype.element_ty), mask=m)

    _KERNELS = (gn_stats_kernel, gn_silu_apply_kernel)
    return _KERNELS


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """Run the two Triton passes on a contiguous CUDA tensor (no counting)."""
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"group_norm_silu kernel takes a float tensor, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu kernel needs a contiguous NCHW tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {x.device}")
    stats_kernel, apply_kernel = _triton_kernels()
    b, c, h, w = x.shape
    hw = h * w
    cg = c // groups
    group_numel = cg * hw
    n_groups = b * groups
    sms = _sm_count(x.device)
    splits = max(1, min(_cdiv(PROGRAMS_PER_SM * sms, n_groups), MAX_SPLITS, _cdiv(group_numel, BLOCK)))
    chunk = _cdiv(_cdiv(group_numel, splits), BLOCK) * BLOCK  # a whole number of BLOCKs
    splits = _cdiv(group_numel, chunk)
    if n_groups > 2**31 - 1 or splits > 65535:
        raise ValueError(f"group_norm_silu kernel grid too large for {tuple(x.shape)}")
    parts = torch.empty((n_groups, splits, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    grid = (n_groups, splits)
    with torch.cuda.device(x.device):
        stats_kernel[grid](x, parts, group_numel, chunk, splits, BLOCK=BLOCK, num_warps=8)
        apply_kernel[grid](
            x, y, weight, bias, parts, group_numel, hw, cg, groups, chunk, splits,
            1.0 / group_numel, eps, NS=MAX_SPLITS, BLOCK=BLOCK, num_warps=8,
        )
    return y


class _GroupNormSiLU(torch.autograd.Function):
    """Forward: the Triton kernel.  Backward: the exact composition, fp32 inside."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y = _launch(x, weight, bias, groups, eps)
        group_norm_silu.launches += 1
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
    launches the Triton kernel or raises.  Differentiable on both.
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
    return _GroupNormSiLU.apply(x, weight, bias, groups, eps)


group_norm_silu.launches = 0


def build(device: str = "cuda") -> None:
    """Compile the Triton kernels for bf16 and fp32 inputs (one small launch each)."""
    dev = resolve_device(device)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((1, 32, 8, 8), dtype=dtype, device=dev)
        w = torch.ones(32, dtype=dtype, device=dev)
        _launch(x, w, torch.zeros_like(w), 16, 1e-5)
    torch.cuda.synchronize(dev)
