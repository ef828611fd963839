"""Flash attention: the CUDA kernels (forward, dQ, dK/dV) and their plain PyTorch versions.

Port of ``mrisr_tpu/ops/flash_attention.py``: ``_flash_kernel`` (launched by
``_flash_forward``) is ``csrc/flash_attn_fwd.cu``; ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (launched by ``_flash_backward``) are
``csrc/flash_attn_bwd.cu``.  Each design and its bound on the H100 are
described in its source.

* ``flash_attention_fwd(q, k, v, scale)`` computes non-causal
  ``softmax(scale * q k^T) v`` on ``[B, N, D]`` / ``[B, M, D]`` and returns
  ``(o [B, N, D] in the input dtype, lse [B, N] float32, natural log)``.
* ``flash_attention_bwd(q, k, v, o, lse, do, scale)`` returns ``(dq, dk, dv)``
  with the probabilities recomputed from ``lse``.
* ``flash_attention(q, k, v, scale)`` returns ``o`` and is differentiable: a
  ``torch.autograd.Function`` over the two (the counterpart of
  ``flash_attention_tpu`` with ``_flash_fwd`` / ``_flash_bwd``).

On a CPU tensor each runs its plain version (``flash_attention_plain``,
``flash_attention_bwd_plain``); on a CUDA tensor it launches its kernels
(bf16 or float32; the bf16 forward takes scale > 0) or raises.  The bf16
forward has two forms, one launch either way: ``fwd_form`` picks the
resident one (a persistent grid holding each batch's K and V in shared
memory) for short K/V and the tiled one otherwise.  The head
widths each kernel takes (``KERNEL_HEAD_DIMS``): D in {32, 64, 128} in bf16,
whose k-step is 16 columns; D in {32, 40, 64, 128} in float32 (tf32's k-step
is 8 columns, so SD1.5's 40-wide heads take no pad in the forward, dQ or
dK/dV kernel).  A narrower head is zero-padded to the next width its kernel
takes and the result sliced back (exact: zero columns add nothing to q k^T,
to o, or to delta).  D > 128 raises.  The float32 kernels run on the tensor
cores in 3xTF32: ``flash_attention_fwd`` and ``flash_attention_bwd`` first
make their operands with ``tf32_fwd_parts`` and ``tf32_parts``.
"""
from __future__ import annotations

import ctypes

import torch

from mrisr_torch._build import build_libraries, load_library
from mrisr_torch.device import device_ctx

KERNEL_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
# (kernel, dtype) -> the head widths it takes: ``fwd`` (B1), ``dq`` (B2a), ``dkv`` (B2b).
_BF16_DIMS, _TF32_DIMS = (32, 64, 128), (32, 40, 64, 128)
KERNEL_HEAD_DIMS = {(kernel, dtype): dims for kernel in ("fwd", "dq", "dkv")
                    for dtype, dims in ((torch.bfloat16, _BF16_DIMS), (torch.float32, _TF32_DIMS))}
PLAIN_CHUNK = 512
# The tensor cores read an fp32 operand of a tf32 product as its bits with the
# 13 low mantissa bits dropped (``mrisr_torch/tools/tf32_probe.py`` checks it
# on the card).  Dropped bits would bias every product toward zero, so the
# fp32 kernels take operands already rounded to tf32 (to nearest, ties away
# from zero, as ``cvt.rna.tf32.f32``): ``tf32_hi`` and ``tf32_lo``.
TF32_MASK = -(1 << 13)
TF32_HALF = 1 << 12
# Rows of the transposed copies are padded with zeros to a multiple of this:
# whole tiles (of at most 64 keys or queries), whole groups of 8 for the
# permutation, and a row stride that is a multiple of 16 bytes for TMA.
TRANSPOSE_PAD = 64


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


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float, chunk: int = PLAIN_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in float32 math, q-chunked like :func:`flash_attention_plain`.

    ``p = exp(scale q k^T - lse)``, ``dp = do v^T``, ``ds = p (dp - delta)``
    with ``delta = rowsum(do * o)``; ``dq = scale ds k``, ``dk = scale ds^T q``,
    ``dv = p^T do``.  Never materialises more than ``[B, chunk, M]``.
    """
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dqs = []
    for i in range(0, q.shape[1], chunk):
        qc, doc = q[:, i : i + chunk].float(), do[:, i : i + chunk].float()
        p = torch.exp(torch.einsum("bnd,bmd->bnm", qc, kf) * scale - lse[:, i : i + chunk, None])
        dv += torch.einsum("bnm,bnd->bmd", p, doc)
        ds = p * (torch.einsum("bnd,bmd->bnm", doc, vf) - delta[:, i : i + chunk, None])
        dqs.append(torch.einsum("bnm,bmd->bnd", ds, kf) * scale)
        dk += torch.einsum("bnm,bnd->bmd", ds, qc) * scale
    return torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """The high part of the 3xTF32 split of fp32 ``x``: ``x`` rounded to tf32 (10 mantissa bits; to
    nearest, ties away from zero)."""
    return ((x.view(torch.int32) + TF32_HALF) & TF32_MASK).view(torch.float32)


def tf32_lo(x: torch.Tensor) -> torch.Tensor:
    """The low part: ``x - tf32_hi(x)`` (exact in fp32) rounded to tf32."""
    return tf32_hi(x - tf32_hi(x))


def transpose_permuted(x: torch.Tensor, pad: int = TRANSPOSE_PAD) -> torch.Tensor:
    """``[B, N, D] -> [B, D, Np]``: the B operand of a tf32 product that sums over N.

    ``Np`` is N rounded up to ``pad`` (a multiple of 8), zeros past N.  Index
    ``n = 8g + 2t + e`` (t < 4, e < 2) goes to position ``8g + 4e + t``: a
    thread's accumulator columns 2t and 2t + 1 become its A fragment's k t and
    t + 4 (``hopper.cuh::to_tf32_frags``), so B's rows are permuted the same way.
    """
    b, n, d = x.shape
    np_ = -(-n // pad) * pad
    if np_ != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, np_ - n))
    return x.reshape(b, np_ // 8, 4, 2, d).permute(0, 4, 1, 3, 2).reshape(b, d, np_)


# The fp32 kernels' operands, in the order of the C interface's `parts`, and the ones each kernel reads:
# the dQ kernel the transposed K, the dK/dV kernel the transposed Q and dO.
TF32_PARTS = ("q_hi", "k_hi", "v_hi", "do_hi", "q_lo", "k_lo", "v_lo", "do_lo",
              "qt", "qt_lo", "dot", "dot_lo", "kt", "kt_lo")
DQ_PARTS = TF32_PARTS[:8] + ("kt", "kt_lo")
DKV_PARTS = TF32_PARTS[:12]


def tf32_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor) -> dict[str, torch.Tensor]:
    """The fp32 backward kernels' 3xTF32 operands: the high and low parts of q, k, v, do ``[B, *, D]``,
    and those of q, do (for dK/dV) and k (for dQ) transposed by :func:`transpose_permuted`.  Plain
    PyTorch; its device time is part of the backward's."""
    parts = {}
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        parts[f"{name}_hi"] = tf32_hi(t)
        parts[f"{name}_lo"] = tf32_hi(t - parts[f"{name}_hi"])
    for name in ("q", "do", "k"):
        parts[f"{name}t"] = transpose_permuted(parts[f"{name}_hi"])
        parts[f"{name}t_lo"] = transpose_permuted(parts[f"{name}_lo"])
    return {name: parts[name] for name in TF32_PARTS}


# The fp32 forward kernel's operands, in the order of the C interface's `parts`.
TF32_FWD_PARTS = ("q_hi", "q_lo", "k_hi", "k_lo", "vt", "vt_lo")


def tf32_fwd_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict[str, torch.Tensor]:
    """The fp32 forward kernel's 3xTF32 operands: the high and low parts of q and k, and those of v
    transposed by :func:`transpose_permuted` (the B operand of P V, which sums over keys).  Plain
    PyTorch; its device time is part of the forward's."""
    v_hi = tf32_hi(v)
    q_hi, k_hi = tf32_hi(q), tf32_hi(k)
    return {"q_hi": q_hi, "q_lo": tf32_hi(q - q_hi), "k_hi": k_hi, "k_lo": tf32_hi(k - k_hi),
            "vt": transpose_permuted(v_hi), "vt_lo": transpose_permuted(tf32_hi(v - v_hi))}


def kernel_head_dim(d: int, dtype: torch.dtype = torch.bfloat16, kernel: str = "fwd") -> int:
    """The head width the ``kernel`` (``fwd``, ``dq`` or ``dkv``) takes a ``dtype`` head of width ``d`` at:
    the least of its ``KERNEL_HEAD_DIMS`` >= d."""
    dims = KERNEL_HEAD_DIMS[kernel, dtype]
    for kd in dims:
        if 1 <= d <= kd:
            return kd
    raise ValueError(f"flash kernel takes D up to {dims[-1]}, got D={d}")


def _pad_head_dim(x: torch.Tensor, d_to: int) -> torch.Tensor:
    """``[B, S, D] -> [B, S, d_to]`` with zero columns past D (``x`` itself when D == d_to)."""
    d = x.shape[-1]
    return x if d == d_to else torch.nn.functional.pad(x, (0, d_to - d))


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


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {  # library -> {C function: argument types}
    "flash_attn_fwd": {
        "mrisr_flash_attn_fwd": [_PTR] * 5 + [_INT] * 5 + [ctypes.c_float, _PTR, _INT, _PTR],
    },
    "flash_attn_bwd": {
        "mrisr_flash_attn_bwd_dq": [_PTR] * 7 + [_INT] * 5 + [ctypes.c_float, _PTR, _PTR],
        "mrisr_flash_attn_bwd_dkv": [_PTR] * 8 + [_INT] * 5 + [ctypes.c_float, _PTR, _PTR],
    },
}


def _kernel_lib(name: str = "flash_attn_fwd", device: str = "cuda") -> ctypes.CDLL:
    lib = load_library(name, device)
    for fn_name, argtypes in _ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


_FNS: dict = {}  # C function name -> its ctypes function, resolved once


def _kernel_fn(fn_name: str):
    fn = _FNS.get(fn_name)
    if fn is None:
        lib = next(lib for lib, fns in _ENTRY_POINTS.items() if fn_name in fns)
        fn = _FNS[fn_name] = getattr(_kernel_lib(lib), fn_name)
    return fn


def _check_kernel_inputs(d: int, batch: int, kernel: str = "fwd", **tensors: torch.Tensor) -> None:
    """Raise on what the ``kernel`` (``fwd``, ``dq`` or ``dkv``) cannot take: D outside its
    ``KERNEL_HEAD_DIMS``, and tensors it cannot read (:func:`_check_tensors`)."""
    _check_tensors(batch, **tensors)
    dtype = next(iter(tensors.values())).dtype
    if d not in KERNEL_HEAD_DIMS[kernel, dtype]:
        raise ValueError(f"flash {kernel} kernel takes D in {KERNEL_HEAD_DIMS[kernel, dtype]} for {dtype}, got {d}")


def _check_tensors(batch: int, **tensors: torch.Tensor) -> None:
    """Raise on tensors the kernels cannot read: they read Q, K, V (and dO, or the float32 kernels' parts)
    through TMA tensor maps, which need a 16-byte aligned base and contiguous rows; lse and delta by row."""
    dtype = next(iter(tensors.values())).dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes bfloat16 or float32, got {dtype}")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")


# The bf16 forward kernel's forms, in the order of the C interface's ``form``: ``tiled`` (a CTA a Q tile,
# K and V streamed through a ring of tiles) and ``resident`` (a persistent CTA an SM walks Q tiles with its
# batch's K and V held in shared memory).
FWD_FORMS = ("tiled", "resident")
# The longest K/V the resident form takes, per head width: 1024 keys at D=32, as many as the kernel holds
# (``Bf16Tiles::kResidentTiles``), where it was faster than the tiled form on the H100
# (``tools/flash_fwd_sweep.py``); the kernel has no resident form at D=64 and 128.
RESIDENT_MAX_KEYS = {32: 1024}


def fwd_form(m: int, d: int, dtype: torch.dtype) -> str:
    """The form of the forward kernel for ``m`` keys at the kernel's head width ``d``: ``resident`` for bf16
    with up to ``RESIDENT_MAX_KEYS[d]`` keys, else ``tiled``."""
    return "resident" if dtype == torch.bfloat16 and m <= RESIDENT_MAX_KEYS.get(d, 0) else "tiled"


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Launch the forward kernel on contiguous CUDA tensors (no counting), in the form :func:`fwd_form`
    gives; for float32 it first makes the kernel's operands (:func:`tf32_fwd_parts`)."""
    b, n, d = q.shape
    m = k.shape[1]
    _check_kernel_inputs(d, b, "fwd", q=q, k=k, v=v)
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"the bf16 flash kernel takes scale > 0, got {scale}")
    parts = tf32_fwd_parts(q, k, v) if q.dtype == torch.float32 else None
    _check_parts(q, k, parts, TF32_FWD_PARTS)
    ptrs = None if parts is None else (ctypes.c_void_p * len(parts))(*(parts[x].data_ptr() for x in TF32_FWD_PARTS))
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with device_ctx(q.device):
        err = _kernel_fn("mrisr_flash_attn_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, m, d, KERNEL_DTYPES[q.dtype], float(scale), ptrs, FWD_FORMS.index(fwd_form(m, d, q.dtype)),
            stream,
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
    d = q.shape[2]
    kd = kernel_head_dim(d, q.dtype, "fwd")
    o, lse = _launch(*(_pad_head_dim(t, kd) for t in (q, k, v)), scale)
    flash_attention_fwd.launches += 1
    for seen in flash_attention_fwd.shapes:  # the recordings open (``ops.recording_shapes``)
        seen[(*q.shape[:2], k.shape[1], d, q.dtype)] += 1
    return (o if kd == d else o[..., :d].contiguous()), lse


flash_attention_fwd.launches = 0
flash_attention_fwd.shapes = []


def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} o {tuple(o.shape)} do {tuple(do.shape)} lse {tuple(lse.shape)}"
        )
    if not (o.dtype == do.dtype == q.dtype) or lse.dtype != torch.float32:
        raise TypeError(f"dtype mismatch: q {q.dtype} o {o.dtype} do {do.dtype} lse {lse.dtype}")
    if {o.device, lse.device, do.device} != {q.device}:
        raise ValueError("tensors on different devices")


def _check_parts(q: torch.Tensor, k: torch.Tensor, parts, names: tuple[str, ...] = TF32_PARTS) -> None:
    """Raise unless ``parts`` holds the ``names`` of what :func:`tf32_parts` (``TF32_PARTS``, or the parts a
    kernel reads: ``DQ_PARTS``, ``DKV_PARTS``) or :func:`tf32_fwd_parts` (``TF32_FWD_PARTS``) makes for
    float32 ``q``, ``k``, at q's head width; None for bf16.  Other parts are not read."""
    if q.dtype != torch.float32:
        if parts is not None:
            raise ValueError("the 3xTF32 parts are for float32 inputs only")
        return
    if parts is None or not set(names) <= set(parts):
        raise ValueError(f"float32 kernels take the parts {names}")
    (b, n, d), m = q.shape, k.shape[1]
    np_, mp = (-(-x // TRANSPOSE_PAD) * TRANSPOSE_PAD for x in (n, m))
    qs, ks = (b, n, d), (b, m, d)
    shapes = {"q_hi": qs, "do_hi": qs, "k_hi": ks, "v_hi": ks, "q_lo": qs, "do_lo": qs, "k_lo": ks, "v_lo": ks,
              "qt": (b, d, np_), "qt_lo": (b, d, np_), "dot": (b, d, np_), "dot_lo": (b, d, np_), "kt": (b, d, mp),
              "kt_lo": (b, d, mp), "vt": (b, d, mp), "vt_lo": (b, d, mp)}
    for name in names:
        t = parts[name]
        if tuple(t.shape) != tuple(shapes[name]) or t.device != q.device:
            raise ValueError(f"part {name}: {tuple(t.shape)} on {t.device}, expected {tuple(shapes[name])} on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"part {name} is {t.dtype}, expected torch.float32")
    _check_tensors(b, **{name: parts[name] for name in names})


def _parts_arg(q, k, v, do, parts, names: tuple[str, ...] = TF32_PARTS):
    """The C interface's ``parts``: a host array of the device pointers of ``names`` in ``TF32_PARTS`` order,
    null for the others (None for bf16), and the parts, which must live until the launch is enqueued."""
    if q.dtype == torch.float32 and parts is None:
        parts = tf32_parts(q, k, v, do)
    _check_parts(q, k, parts, names)
    if parts is None:
        return None, None
    ptrs = (parts[x].data_ptr() if x in names else None for x in TF32_PARTS)
    return (ctypes.c_void_p * len(TF32_PARTS))(*ptrs), parts


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float, parts=None) -> torch.Tensor:
    """Launch the dQ kernel: ``delta`` is ``rowsum(do * o)`` in float32, ``[B, N]``; ``parts`` (float32
    only) is :func:`tf32_parts` of the inputs, made here when not given.  D as the kernel takes it."""
    b, n, d = q.shape
    _check_kernel_inputs(d, b, "dq", q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    ptrs, parts = _parts_arg(q, k, v, do, parts, DQ_PARTS)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with device_ctx(q.device):
        err = _kernel_fn("mrisr_flash_attn_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, n, k.shape[1], d, KERNEL_DTYPES[q.dtype], float(scale), ptrs, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: cudaError {err}")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float, parts=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel; arguments as :func:`flash_attention_bwd_dq`."""
    b, n, d = q.shape
    _check_kernel_inputs(d, b, "dkv", q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    ptrs, parts = _parts_arg(q, k, v, do, parts, DKV_PARTS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with device_ctx(q.device):
        err = _kernel_fn("mrisr_flash_attn_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, n, k.shape[1], d, KERNEL_DTYPES[q.dtype], float(scale), ptrs, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: cudaError {err}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the cotangent ``do`` of ``o``."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    # As in the reference, delta is reduced outside the kernels; so are the
    # float32 kernels' 3xTF32 parts, made once for both.  A head narrower
    # than the kernels' is zero-padded after delta is taken and sliced back.
    delta = (do.float() * o.float()).sum(dim=-1)
    d = q.shape[2]
    for seen in flash_attention_bwd.shapes:
        seen[(*q.shape[:2], k.shape[1], d, q.dtype)] += 1
    kd = kernel_head_dim(d, q.dtype, "dkv")
    q, k, v, do = (_pad_head_dim(t, kd) for t in (q, k, v, do))
    parts = tf32_parts(q, k, v, do) if q.dtype == torch.float32 else None
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, parts)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, parts)
    if kd == d:
        return dq, dk, dv
    return tuple(t[..., :d].contiguous() for t in (dq, dk, dv))


flash_attention_bwd.shapes = []


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Differentiable non-causal attention ``[B, N, D] -> [B, N, D]``; see the module docstring."""
    return _FlashAttention.apply(q, k, v, scale)


LIBRARIES = tuple(_ENTRY_POINTS)


def build(device: str = "cuda") -> None:
    """Compile (if needed, both sources at once) and load the kernel libraries."""
    build_libraries(LIBRARIES, device)
    for name in LIBRARIES:
        _kernel_lib(name, device)
