"""Flash-attention forward: CUDA kernel and its plain PyTorch version.

Port of ``mrisr_tpu/ops/flash_attention.py::_flash_kernel`` (launched by
``_flash_forward``).  The kernel is ``csrc/flash_attn_fwd.cu``; its design and
its bound on the H100 are described there.

``flash_attention_fwd(q, k, v, scale)`` computes non-causal
``softmax(scale * q k^T) v`` on ``[B, N, D]`` / ``[B, M, D]`` and returns
``(o [B, N, D] in the input dtype, lse [B, N] float32, natural log)``.
On a CPU tensor it runs :func:`flash_attention_plain`; on a CUDA tensor it
launches the kernel (bf16 or float32, D in {32, 64, 128}) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from mrisr_torch._build import load_library

KERNEL_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
KERNEL_HEAD_DIMS = (32, 64, 128)
PLAIN_CHUNK = 512


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, chunk: int = PLAIN_CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact q-chunked softmax attention in float32; returns ``(o, lse)``.

    Never materialises more than ``[B, chunk, M]`` scores.  Any N, M, D.
    """
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for i in range(0, q.shape[1], chunk):
        logits = torch.einsum("bnd,bmd->bnm", q[:, i : i + chunk].float(), kf) * scale
        lse = torch.logsumexp(logits, dim=-1)
        p = torch.exp(logits - lse[..., None])
        outs.append(torch.einsum("bnm,bmd->bnd", p, vf))
        lses.append(lse)
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash attention takes [B, N, D] tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype} {k.dtype} {v.dtype}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def _kernel_lib(device: str = "cuda") -> ctypes.CDLL:
    lib = load_library("flash_attn_fwd", device)
    fn = lib.mrisr_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Launch the CUDA kernel on contiguous CUDA tensors (no counting)."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes bfloat16 or float32, got {q.dtype}")
    b, n, d = q.shape
    m = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes D in {KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit")
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_lib().mrisr_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, m, d, KERNEL_DTYPES[q.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of non-causal attention; see the module docstring."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch(q, k, v, scale)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def build(device: str = "cuda") -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    return _kernel_lib(device)
