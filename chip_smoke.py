#!/usr/bin/env python3
"""Drive the PyTorch port (``mrisr_torch``) on one NVIDIA GPU and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
kernels from the sources in the checkout (``nvcc`` for the CUDA flash
attention forward and backward and GroupNorm+SiLU, one process per source,
all started together), so nothing else needs to be built first.  It needs one CUDA
card; without one, or when any phase fails, it exits non-zero and prints no
result.  Each phase prints JSON lines:

1. ``device``: the card, and its name and power limit from nvidia-smi;
2. ``build``: seconds to build the kernels, the ptxas register report (no
   spills, and no serialized wgmma pipeline -- ptxas's "Performance Loss"
   notes -- in any CUDA library), and the HGMMA (wgmma) instruction count
   of each flash kernel, bf16 and fp32 (3xTF32) forward, dQ and dK/dV at
   D = 32, 64, 128, from ``cuobjdump -sass`` (none of the 18 may be 0);
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 and fp32 (plus ragged shapes, ragged
   shapes where every score is below -100, and head widths the kernels pad:
   D = 16 and 40), with its time beside its bound, the plain version's time
   and one PyTorch library call's time (timed only; the port never calls
   it); the kernel's own device time (``torch.profiler``) and the wrapper's
   host microseconds per call; for fp32 a tensor-core (3xTF32) bound beside
   the FMA bound and the device time of the 3xTF32 operand prep (the
   forward's also with its prep, against the library call's device time);
   the backward's results bitwise equal over two calls; gradients through
   the autograd function against the direct backward call; GroupNorm+SiLU
   at all 13 shapes of the UNet;
4. ``chain``: the full-width 256^2, bs-8, bf16, 50-step ResDiff serving chain
   through ``ResDiffPipeline.super_resolve``, in the fast (ca_kv_pool=8) and
   exact (ca_kv_pool=0) profiles, with the kernels' launch counts checked,
   then one more chain of each profile traced with ``torch.profiler``
   (``profile``: the device's busy time, idle share and largest kernels);
5. ``forward``: one full-width bs-1 fp32 UNet forward on the card (TF32 off)
   against the plain path on the CPU, and the same for the reference's
   parity-harness UNet (128^2, inner 16, 8 norm groups), whose 64^2
   cross-attention has heads of D=16 (padded to 32);
6. ``train``: full-width training steps (256^2, bs 8, dropout 0.2, Adam 1e-5,
   EMA 0.999) through ``make_resdiff_train_step``: 3 in fp32, 3 with the bf16
   policy, 1 with bf16 and remat, each with its launch counts, loss,
   parameter and EMA movement, ms and peak memory; then one traced step of
   each policy (``train_profile``, bf16 and float32);
7. ``grad``: one full-width bs-1 fp32 step's gradients on the card (TF32 off,
   dropout 0, kernels on) against the CPU plain path, per parameter; and
   the same for the parity-harness UNet.

Then the kernels summary line, the nvidia-smi line, and last the result line.
``--phases a,b`` runs only the named phases (device and build always run);
``--log FILE`` also writes every JSON line to FILE.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): tensor-core bf16, fp32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# TF32 on the tensor cores; a 3xTF32 product takes three passes at this rate.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# Approximate exp throughput of the special-function units (informational).
PEAK_EXPS = 3.7e12

BATCH, SIZE, STEPS = 8, 256, 50
FLASH_CASES = [  # (case, B, N, M, D): the chain's two flash sites, both profiles
    ("site0_exact", BATCH, 16384, 16384, 32),
    ("site0_fast", BATCH, 16384, 256, 32),
    ("site1_exact", BATCH, 4096, 4096, 64),
    ("site1_fast", BATCH, 4096, 64, 64),
]
FLASH_RAGGED = [("ragged", 2, 1000, 777, 32), ("ragged", 1, 333, 4097, 64), ("ragged", 3, 130, 70, 128),
                # fewer queries than one CTA and keys than one tile; keys ending mid-tile at B >= 2, D=64
                ("ragged", 2, 37, 5, 32), ("ragged", 2, 300, 1000, 64)]
# Ragged shapes where every score is below -100 (extreme_qk): a zero key past
# M would score 0 and get p = exp(-lse), which overflows.
FLASH_EXTREME = [("extreme", 2, 300, 1000, 64), ("extreme", 2, 1000, 777, 32)]
# Head widths the kernels do not have: the wrappers pad D to 32 and 64.
FLASH_PAD = [("pad", 2, 4096, 4096, 16), ("pad", 2, 1000, 777, 40)]
EXTREME_MEAN_SCORE, EXTREME_NOISE = -130.0, 2.0
# (case, shape, groups): the 13 shapes of the UNet's 29 ConvBlock heads at bs 8
# (C @ H^2: 32, 64, 96 @ 256^2; 32, 64, 96, 192 @ 128^2; 64, 128, 192, 256
# @ 64^2; 128, 256 @ 32^2), the largest first and the smallest second.
GN_CASES = [("largest", (BATCH, 96, 256, 256), 16), ("smallest", (BATCH, 128, 32, 32), 16)] + [
    ("chain", (BATCH, c, hw, hw), 16) for c, hw in ((32, 256), (64, 256), (32, 128), (64, 128), (96, 128),
                                                    (192, 128), (64, 64), (128, 64), (192, 64), (256, 64),
                                                    (256, 32))]
# Ragged shapes (one element a unit, one CTA a span), and spans whose slices
# do not fit shared memory (x read twice): 2 MB in bf16, 4 MB in fp32.
GN_RAGGED = [("ragged", (3, 24, 17, 19), 4), ("ragged", (1, 6, 5, 7), 3), ("ragged", (2, 512, 3, 5), 16),
             ("reread", (2, 64, 256, 256), 4)]
# Stated before the run.  O is held to what it is compared with: each element
# within o_atol_rms * rms(ref) + o_rtol * |ref|, and rms(err) within
# o_rms_rel * rms(ref).  Over 16384 keys a typical |O| is only ~0.013, so a
# fixed atol would pass a wrong P.V.  bf16: the kernel rounds p to bf16 for
# the PV product and its denominator (2^-9 relative) and both sides round O to
# bf16 (one ulp is 2^-8 relative); fp32: exp2f's 2-ulp error and a different
# summation order.
FLASH_TOL = {"bfloat16": dict(o_atol_rms=5e-2, o_rtol=2e-2, o_rms_rel=1e-2, lse_atol=1e-2),
             "float32": dict(o_atol_rms=1e-3, o_rtol=1e-4, o_rms_rel=1e-4, lse_atol=1e-4)}
# The backward kernels, each of dq, dk, dv held like O above.  Both sides
# recompute P from the same lse (the forward kernel's), so the forward's bf16
# denominator is shared and not part of the error.  bf16: the kernels round P
# and dS to bf16 for the tensor cores (2^-9 relative per term, random over the
# summed keys or queries) and both sides round the result to bf16; fp32:
# exp2f's 2-ulp error and a different summation order.
FLASH_BWD_TOL = {"bfloat16": dict(atol_rms=5e-2, rtol=2e-2, rms_rel=1e-2),
                 "float32": dict(atol_rms=1e-3, rtol=1e-4, rms_rel=1e-4)}
# bf16: one output ulp (2^-8 relative) either way; fp32: E[x^2]-mean^2 vs two-pass variance.
GN_TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2), "float32": dict(atol=1e-4, rtol=1e-4)}
# Full forward, fp32 with TF32 off: the North-star forward bar.
FORWARD_TOL = dict(atol=2e-4, rtol=1e-3)
# Gradients of one fp32 step, card (kernels) against CPU (plain), per parameter
# leaf: ||g_gpu - g_cpu|| <= GRAD_TOL * ||g_cpu||.  Both are fp32 sums in
# different orders through ~100 layers.
GRAD_TOL = 1e-3
GRAD_SIZE = 256
# A UNet whose 64^2 cross-attention (4096 tokens) has heads of D=16: the
# reference's parity harness (mrisr_tpu/eval/parity.py: inner 16, 8 norm
# groups).  One flash site, 29 heads.
NARROW = dict(image_size=128, inner_channel=16, norm_groups=8)
NARROW_LAUNCHES = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
                   "group_norm_silu": 29}
TRAIN_LR, TRAIN_EMA = 1e-5, 0.999
# Launches per training step at 256^2: two CA sites with >= 4096 tokens, 29
# ConvBlock heads; with remat the forward runs twice.
TRAIN_LAUNCHES = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2,
                  "group_norm_silu": 29}


LOG = None  # a file that also gets every JSON line (--log), for runs whose output is cut


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG is not None:
        LOG.write(line + "\n")
        LOG.flush()


def cuda_ms(torch, fn, min_total_ms=200.0, max_iters=50):
    """Mean ms per call over a run of calls timed with CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, min_total_ms / first)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def window_ms(seen, iters):
    """``(per_call, ms)`` from one profiler window of ``iters`` calls, or None when the window is refused.

    ``seen`` maps each kind of device event to ``(count, total device us)``.  The tracer may miss events
    at the start of a window, so the window's total is not used: each kind counts at its mean time per
    event seen, times ``per_call[kind]``, the number of times one call makes it.  That number is the
    count over ``iters`` rounded up.  The window is refused when a kind saw half of its events or fewer
    (the rounding could then be wrong), or when it saw no event at all.
    """
    per_call = {key: -(-count // iters) for key, (count, _) in seen.items()}
    if not seen or any(2 * count <= (2 * per_call[key] - 1) * iters for key, (count, _) in seen.items()):
        return None
    return per_call, sum(total / count * per_call[key] for key, (count, total) in seen.items()) / 1e3


def device_ms(torch, fn, kernel_part=None, iters=20, attempts=4):
    """Mean device time per call, from ``torch.profiler``: of the kernels whose name holds ``kernel_part``,
    or with ``kernel_part=None`` of every device event a call makes.

    Each window of ``iters`` calls is read by :func:`window_ms`.  The result is the mean of a window and
    the last window accepted before it, once the two agree on the kinds of event and their number per
    call (a kind the tracer missed throughout one window shows as a disagreement).  None when no two of
    ``attempts`` windows agree.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    last = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = window_ms({e.key: (e.count, e.device_time_total) for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and (kernel_part is None or kernel_part in e.key)},
                        iters)
        if got is not None and last is not None and got[0] == last[0]:
            return (got[1] + last[1]) / 2
        last = got or last
    return None


def host_us(torch, fn, iters=200):
    """Host microseconds per call: the time to enqueue ``iters`` calls, before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def set_bounds(rec, n_bytes, flops, bf16):
    """``bound_ms``/``bound_by`` of a flash record: bf16 on the tensor cores; fp32 as 3xTF32 on the tensor
    cores (three passes of every product, ``bound_kind``), with the FMA bound (``fma_bound_ms``) beside it."""
    if bf16:
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops, PEAK_BF16_FLOPS)
    else:
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 3.0 * flops, PEAK_TF32_FLOPS)
        rec["bound_kind"] = "3xtf32_tensor_cores"
        rec["fma_bound_ms"], rec["fma_bound_by"] = bound(n_bytes, flops, PEAK_FP32_FLOPS)


def phase_device(torch):
    if torch.cuda.device_count() < 1:
        raise RuntimeError("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def extreme_qk(q, k):
    """``q``, ``k`` ([..., D] float tensors of unit noise) moved so that every score ``q.k / sqrt(D)`` is
    about ``EXTREME_MEAN_SCORE``: the noise, centred over D and scaled by ``EXTREME_NOISE``, plus ``+h``
    and ``-h`` in every coordinate.  Centred noise is orthogonal to the shift, so the shift adds the same
    -h^2 D / sqrt(D) to every score and leaves a spread of about ``EXTREME_NOISE**2`` around it."""
    d = q.shape[-1]
    h = math.sqrt(-EXTREME_MEAN_SCORE / math.sqrt(d))
    centred = [EXTREME_NOISE * (t - t.mean(dim=-1, keepdim=True)) for t in (q, k)]
    return centred[0] + h, centred[1] - h


def kernel_name(mangled):
    """``flash_{fwd,bwd}_<...>_kernel<D>`` from a mangled flash kernel name, else the name as given.

    The kernels sit in an anonymous namespace, which nvcc names after the source file
    (``..._flash_attn_bwd_cu_e9fa0b7425flash_bwd_dq_bf16_kernelILi32EE...``): the name starts at the
    first ``flash_fwd_`` or ``flash_bwd_``."""
    import re

    m = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]*?kernel)ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def sass_counts(so_path, opcode):
    """Instructions with ``opcode`` in each kernel of a built library, from ``cuobjdump -sass``."""
    import os

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so_path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def phase_build(torch):
    from mrisr_torch import _build
    from mrisr_torch.ops import build_kernels, flash_attention, groupnorm

    t0 = time.perf_counter()
    build_kernels()
    t1 = time.perf_counter()
    libraries = flash_attention.LIBRARIES + groupnorm.LIBRARIES
    ptxas = {name: _build.ptxas_report(name) for name in libraries}
    spills = {name: sum("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln for ln in lines)
              for name, lines in ptxas.items()}
    # Every flash kernel -- bf16 and fp32 (3xTF32) forward, dQ and dK/dV at
    # D = 32, 64, 128 -- is built on wgmma: the SASS of each must hold HGMMA
    # instructions.
    hgmma = {k: n for lib in flash_attention.LIBRARIES
             for k, n in sass_counts(_build.build_dir() / f"lib{lib}.so", "HGMMA").items()
             if k.startswith(("flash_fwd_", "flash_bwd_"))}
    emit({"phase": "build", "nvcc_s": t1 - t0, "sources": list(libraries),
          "kernels_with_spills": spills, "flash_hgmma": hgmma, "ptxas": ptxas})
    # ptxas notes a wgmma pipeline it had to serialize (the design's overlap lost).
    serialized = [ln for lines in ptxas.values() for ln in lines if "Performance Loss" in ln]
    if len(hgmma) != 18 or not all(hgmma.values()) or any(spills.values()) or serialized:
        raise AssertionError(f"build: HGMMA counts {hgmma}, kernels with spills {spills}, "
                             f"ptxas performance notes {serialized}")


def flash_inputs(torch, dtype, case, seed, sizes, d):
    """Unit normal ``[b, s, d]`` tensors (``sizes`` gives ``(b, s)`` of each, q and k first) in ``dtype``;
    for the extreme cases q and k go through :func:`extreme_qk` first."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ts = [torch.randn((b, s, d), generator=gen, device="cuda") for b, s in sizes]
    if case == "extreme":
        ts[0], ts[1] = extreme_qk(ts[0], ts[1])
    return [t.to(dtype) for t in ts]


def check_flash(torch, F, dtype, case, b, n, m, d, timed):
    from mrisr_torch.ops import flash_attention as fa

    q, k, v = flash_inputs(torch, dtype, case, b * 7 + n + m + d, [(b, n), (b, m), (b, m)], d)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    ro, rlse = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = FLASH_TOL[name]
    ref = ro.float()
    rms_ref = float(ref.square().mean().sqrt())
    o_err = (o.float() - ref).abs()
    o_limit = tol["o_atol_rms"] * rms_ref + tol["o_rtol"] * ref.abs()
    rms_err_rel = float(o_err.square().mean().sqrt()) / rms_ref
    lse_err = (lse - rlse).abs()
    ok = (bool((o_err <= o_limit).all()) and rms_err_rel <= tol["o_rms_rel"]
          and bool((lse_err <= tol["lse_atol"]).all()))
    rec = {"phase": "kernel", "kernel": "flash_attention_fwd", "case": case, "dtype": name,
           "shape": [b, n, m, d], "max_abs_err": float(o_err.max()), "o_atol": tol["o_atol_rms"] * rms_ref,
           "o_err_over_limit": float((o_err / o_limit).max()), "ref_rms": rms_ref, "rms_err_rel": rms_err_rel,
           "lse_max_abs_err": float(lse_err.max()), "max_rel_err": float(o_err.max() / ref.abs().max()),
           "tolerance": tol, "ok": ok}
    if timed:
        size = q.element_size()
        n_bytes = (2 * b * n * d + 2 * b * m * d) * size + 4 * b * n
        set_bounds(rec, n_bytes, 4.0 * b * n * m * d, dtype == torch.bfloat16)
        rec["exp_floor_ms"] = b * n * m / PEAK_EXPS * 1e3
        rec["ms"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale))
        # The kernel alone (device time) and the wrapper's host time per call:
        # where ms is near host_us and well above device_ms, the wrapper sets the time.
        rec["device_ms"] = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), "flash_fwd_")
        # fp32 makes its operands first (some 20 launches a call): few calls, so the launch queue never
        # fills and the enqueue is not held back by the device.
        rec["host_us"] = host_us(torch, lambda: fa.flash_attention_fwd(q, k, v, scale),
                                 iters=200 if dtype == torch.bfloat16 else 20)
        rec["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, scale), max_iters=10)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]  # [B, 1 head, N, D]: fused backends take 4-D
        run_library = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
        rec["library_ms"] = cuda_ms(torch, run_library, max_iters=10)
        if dtype == torch.float32:  # the 3xTF32 operands are made in every call: "fwd with prep"
            rec["prep_device_ms"] = device_ms(torch, lambda: fa.tf32_fwd_parts(q, k, v), None)
            rec["with_prep_device_ms"] = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), None)
            rec["library_device_ms"] = device_ms(torch, run_library, None, iters=10)
    emit(rec)
    if not ok:
        raise AssertionError(f"flash attention disagrees with its plain version: {rec}")
    return rec


def check_flash_bwd(torch, F, dtype, case, b, n, m, d, timed):
    """dQ and dK/dV through ``flash_attention_bwd`` against ``flash_attention_bwd_plain``."""
    from mrisr_torch.ops import flash_attention as fa

    q, k, v, do = flash_inputs(torch, dtype, case, b * 11 + n + m + d, [(b, n), (b, m), (b, m), (b, n)], d)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    # No atomics: each block writes only the rows it owns, so a second call gives the same bits.
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    name = str(dtype).split(".")[-1]
    tol = FLASH_BWD_TOL[name]
    errs, ok = {}, deterministic
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        ref = w.float()
        rms_ref = float(ref.square().mean().sqrt())
        err = (g.float() - ref).abs()
        limit = tol["atol_rms"] * rms_ref + tol["rtol"] * ref.abs()
        errs[key] = {"max_abs_err": float(err.max()), "err_over_limit": float((err / limit).max()),
                     "ref_rms": rms_ref, "rms_err_rel": float(err.square().mean().sqrt()) / rms_ref}
        ok = (ok and bool(torch.isfinite(g).all()) and errs[key]["err_over_limit"] <= 1.0
              and errs[key]["rms_err_rel"] <= tol["rms_rel"])
    base = {"phase": "kernel", "case": case, "dtype": name, "shape": [b, n, m, d], "tolerance": tol,
            "deterministic": deterministic, "ok": ok}
    recs = {"flash_attention_bwd_dq": {**base, "kernel": "flash_attention_bwd_dq", "errors": {"dq": errs["dq"]},
                                       "max_abs_err": errs["dq"]["max_abs_err"]},
            "flash_attention_bwd_dkv": {**base, "kernel": "flash_attention_bwd_dkv",
                                        "errors": {"dk": errs["dk"], "dv": errs["dv"]},
                                        "max_abs_err": max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])}}
    if timed:
        size = q.element_size()
        bf16 = dtype == torch.bfloat16
        delta = (do.float() * o.float()).sum(dim=-1)
        dq_rec, dkv_rec = recs["flash_attention_bwd_dq"], recs["flash_attention_bwd_dkv"]
        # Each input read once, each output written once; three products for dQ, four for dK/dV.
        set_bounds(dq_rec, (3 * b * n * d + 2 * b * m * d) * size + 8 * b * n, 6.0 * b * n * m * d, bf16)
        set_bounds(dkv_rec, (2 * b * n * d + 4 * b * m * d) * size + 8 * b * n, 8.0 * b * n * m * d, bf16)
        # fp32: the kernels alone, on 3xTF32 operands made once; the pair below makes its own.
        parts = None if bf16 else fa.tf32_parts(q, k, v, do)
        run_dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, parts)  # noqa: E731
        run_dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, parts)  # noqa: E731
        for rec, run, kernel_part in ((dq_rec, run_dq, "flash_bwd_dq"), (dkv_rec, run_dkv, "flash_bwd_dkv")):
            rec["ms"] = cuda_ms(torch, run)
            rec["device_ms"] = device_ms(torch, run, kernel_part)
            rec["host_us"] = host_us(torch, run)
        run_pair = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
        # The plain version and the library call compute dq, dk and dv in one
        # pass: their times are those of the whole backward, on both records.
        # So is the pair's (delta, dQ, dK/dV): the device times compare them
        # without the wrappers' host time.
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale), max_iters=5)
        q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        run_library = lambda: torch.autograd.grad(out4, (q4, k4, v4), do[:, None], retain_graph=True)  # noqa: E731
        pair = {"pair_ms": cuda_ms(torch, run_pair), "pair_device_ms": device_ms(torch, run_pair, None),
                "plain_ms": plain_ms, "library_ms": cuda_ms(torch, run_library, max_iters=10),
                "library_device_ms": device_ms(torch, run_library, None, iters=10)}
        if not bf16:  # the 3xTF32 operands' device time, part of the pair's
            pair["prep_device_ms"] = device_ms(torch, lambda: fa.tf32_parts(q, k, v, do), None)
        for rec in (dq_rec, dkv_rec):
            rec.update(exp_floor_ms=b * n * m / PEAK_EXPS * 1e3, **pair,
                       plain_and_library_cover="dq, dk and dv together")
    for rec in recs.values():
        emit(rec)
    if not ok:
        raise AssertionError(f"flash attention backward disagrees with its plain version: {recs}")
    return recs


def check_flash_autograd(torch):
    """Gradients through the ``flash_attention`` autograd function equal the direct backward call."""
    from mrisr_torch.ops import flash_attention as fa

    _, b, n, m, d = FLASH_CASES[2]
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16) for s in (n, m, m, n))
    scale = 1.0 / math.sqrt(d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, scale)
    through = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    direct = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ok = torch.equal(out, o) and all(torch.equal(a, b_) for a, b_ in zip(through, direct))
    emit({"phase": "kernel", "kernel": "flash_attention", "case": "autograd_equals_direct_backward",
          "shape": [b, n, m, d], "dtype": "bfloat16", "ok": ok})
    if not ok:
        raise AssertionError("gradients through flash_attention differ from flash_attention_bwd")


def check_gn(torch, F, dtype, case, shape, groups, timed, backward=False):
    from mrisr_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + groups)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    y = gn.group_norm_silu(x, w, bias, groups, 1e-5)
    ref = gn.group_norm_silu_plain(x, w, bias, groups, 1e-5)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = GN_TOL[name]
    err = (y.float() - ref.float()).abs()
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    ok = bool((err <= limit).all())
    rec = {"phase": "kernel", "kernel": "group_norm_silu", "case": case, "dtype": name,
           "shape": list(shape), "groups": groups, "max_abs_err": float(err.max()),
           "err_over_limit": float((err / limit).max()),
           "max_rel_err": float(err.max() / ref.float().abs().max()), "tolerance": tol, "ok": ok}
    if timed:
        numel = x.numel()
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * numel * x.element_size() + 2 * c * w.element_size(), 10.0 * numel, PEAK_FP32_FLOPS)
        run = lambda: gn.group_norm_silu(x, w, bias, groups, 1e-5)  # noqa: E731
        run_library = lambda: F.silu(F.group_norm(x, groups, w, bias, 1e-5))  # noqa: E731
        rec["plan"] = gn.gn_plan(tuple(shape), groups, x.element_size())._asdict()
        rec["ms"] = cuda_ms(torch, run)
        rec["device_ms"] = device_ms(torch, run, None)
        rec["host_us"] = host_us(torch, run)
        rec["plain_ms"] = cuda_ms(torch, lambda: gn.group_norm_silu_plain(x, w, bias, groups, 1e-5))
        rec["library_ms"] = cuda_ms(torch, run_library)
        rec["library_device_ms"] = device_ms(torch, run_library, None)
    if backward:  # the backward has no kernel (nor has the reference's): the exact composition, timed alone
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        out = gn.group_norm_silu(*leaves, groups, 1e-5)
        rec["backward_composition_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(out, leaves, y, retain_graph=True), max_iters=20)
    emit(rec)
    if not ok:
        raise AssertionError(f"group_norm_silu disagrees with its plain version: {rec}")
    return rec


def phase_kernels(torch):
    import torch.nn.functional as F

    recs = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
            "group_norm_silu": []}
    for dtype in (torch.bfloat16, torch.float32):
        for cases, timed in ((FLASH_CASES, True), (FLASH_RAGGED, False), (FLASH_EXTREME, False),
                             (FLASH_PAD, False)):
            for case in cases:
                recs["flash_attention_fwd"].append(check_flash(torch, F, dtype, *case, timed=timed))
                for name, rec in check_flash_bwd(torch, F, dtype, *case, timed=timed).items():
                    recs[name].append(rec)
        for i, case in enumerate(GN_CASES):
            recs["group_norm_silu"].append(check_gn(torch, F, dtype, *case, timed=True, backward=i < 2))
        for case in GN_RAGGED:
            recs["group_norm_silu"].append(check_gn(torch, F, dtype, *case, timed=False))
    check_flash_autograd(torch)
    return recs


def profile_chain(torch, run, chain_ms, top=12, ranges=()):
    """Device time of one chain (or one training step) by kernel, from ``torch.profiler``.

    The device's busy time is the sum of the times of the events that ran on
    the device (kernels, copies; one stream, so they do not overlap). Its
    idle share is taken against ``chain_ms``, the same chain timed without the
    profiler, and against the profiled chain's own wall time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.key not in ranges]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # Named ranges (record_function): the device time from the first to the last
    # kernel launched inside each, any gap between them included.
    in_ranges = {e.key: {"device_span_ms": e.device_time_total / 1e3, "count": e.count}
                 for e in events if e.device_type == DeviceType.CUDA and e.key in ranges}
    return {"device_busy_ms": busy_ms, "ranges": in_ranges, "idle_share": 1.0 - busy_ms / chain_ms,
            "profiled_chain_ms": profiled_ms, "profiled_idle_share": 1.0 - busy_ms / profiled_ms,
            "device_events": sum(r[2] for r in rows),
            "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top]]}


def phase_chain(torch):
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.ops import launch_counts, reset_launch_counts
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    n_sites = 2  # CA sites with >= 4096 tokens at 256^2: the 128^2 and 64^2 skips
    n_gn = 2 * 14 + 1  # two ConvBlocks per ResnetBlock, 14 ResnetBlocks, plus final_conv
    # A serving chain launches no backward kernel.
    expect = {"flash_attention_fwd": n_sites * STEPS, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "group_norm_silu": n_gn * STEPS}
    totals = {k: 0 for k in expect}
    outs = {}
    for profile, kv_pool in (("fast", 8), ("exact", 0)):
        torch.manual_seed(0)  # the same random weights in both profiles
        cnn = SimpleCNN(device="cuda").to(torch.bfloat16)
        unet = ResDiffUNet(image_size=SIZE, ca_kv_pool=kv_pool, device="cuda").to(torch.bfloat16)
        pipe = ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        lr = (torch.rand((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
        x_T = torch.randn((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda").to(torch.bfloat16)

        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if counts != expect:
            raise AssertionError(f"{profile}: launch counts {counts}, expected {expect}")
        for k in totals:
            totals[k] += counts[k]
        if tuple(out.shape) != (BATCH, SIZE, SIZE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{profile}: bad output {tuple(out.shape)}")

        t0 = time.perf_counter()
        again = pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS)
        torch.cuda.synchronize()
        chain_ms = (time.perf_counter() - t0) * 1e3
        outs[profile] = out.float()
        emit({"phase": "chain", "profile": profile, "ca_kv_pool": kv_pool, "batch": BATCH, "size": SIZE,
              "steps": STEPS, "dtype": "bfloat16", "launches": counts, "first_chain_ms": first_ms,
              "chain_ms": chain_ms, "slices_per_s": BATCH / (chain_ms / 1e3),
              "repeat_max_abs_diff": float((again.float() - out.float()).abs().max()),
              "out_abs_max": float(out.float().abs().max())})
        rec = profile_chain(torch, lambda: pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS), chain_ms)
        emit({"phase": "profile", "profile": profile, "chain_ms": chain_ms, **rec})
    emit({"phase": "chain", "fast_vs_exact_max_abs_diff": float((outs["fast"] - outs["exact"]).abs().max())})
    return totals


def phase_forward(torch):
    """The fp32 UNet forward on the card against the CPU plain path: full width at 256^2, and the parity
    harness's UNet (heads of D=16 at its flash site)."""
    serving = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    check_forward(torch, dict(image_size=SIZE), 2, {**TRAIN_LAUNCHES, **serving})
    check_forward(torch, NARROW, 12, {**NARROW_LAUNCHES, **serving})


def check_forward(torch, unet_kwargs, seed, expect):
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    size = unet_kwargs["image_size"]
    torch.manual_seed(seed)
    gpu = ResDiffUNet(**unet_kwargs, device="cuda")
    cpu = ResDiffUNet(**unet_kwargs, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((1, 2, size, size), generator=gen)
    gamma = torch.tensor([0.7])
    with torch.no_grad():
        reset_launch_counts()
        out_gpu = gpu(x.cuda(), gamma.cuda()).cpu()
        counts = launch_counts()
        t0 = time.perf_counter()
        out_cpu = cpu(x, gamma)
        cpu_s = time.perf_counter() - t0
    err = (out_gpu - out_cpu).abs()
    ok = bool((err <= FORWARD_TOL["atol"] + FORWARD_TOL["rtol"] * out_cpu.abs()).all()) and counts == expect
    rec = {"phase": "forward", "unet": unet_kwargs, "shape": [1, 2, size, size], "dtype": "float32",
           "tf32": False, "launches": counts, "max_abs_err": float(err.max()),
           "ref_abs_max": float(out_cpu.abs().max()), "tolerance": FORWARD_TOL, "cpu_forward_s": cpu_s, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"forward on the card disagrees with the CPU plain path (launches {expect}): {rec}")


def _synthetic_batch(torch, batch, size, seed, device):
    """A fixed-seed ``{"sr", "hr"}`` batch of ``[B, S, S, 1]`` images in [-1, 1]; sr is hr blurred by noise."""
    gen = torch.Generator().manual_seed(seed)
    hr = torch.rand((batch, size, size, 1), generator=gen) * 2 - 1
    sr = (hr + 0.1 * torch.randn(hr.shape, generator=gen)).clamp(-1, 1)
    return {"sr": sr.to(device), "hr": hr.to(device)}


def phase_train(torch):
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.ops import launch_counts, reset_launch_counts
    from mrisr_torch.train.precision import get_policy
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_resdiff_train_step, step_generator

    torch.manual_seed(4)
    unet = ResDiffUNet(image_size=SIZE)  # the trainer's defaults: dropout 0.2, ca_kv_pool 0
    sched = resdiff_schedule(1000)
    batch = _synthetic_batch(torch, BATCH, SIZE, 5, "cuda")
    totals = {k: 0 for k in TRAIN_LAUNCHES}
    for precision, remat, n_steps in (("float32", False, 3), ("bfloat16", False, 3), ("bfloat16", True, 1)):
        state = create_train_state(unet, make_optimizer(TRAIN_LR), ema_decay=TRAIN_EMA)
        step = make_resdiff_train_step(unet, sched, get_policy(precision), remat=remat)
        expect = dict(TRAIN_LAUNCHES)
        if remat:  # the forward runs twice
            expect.update(flash_attention_fwd=4, group_norm_silu=58)
        for i in range(n_steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            new, metrics = step(state, batch, step_generator(6, i, "cuda"))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            for k in totals:
                totals[k] += counts[k]
            loss = float(metrics["loss"])
            moved = max(float((new.params[k] - p).abs().max()) for k, p in state.params.items())
            # One Adam step moves a parameter by about lr (at most (1-b1)/sqrt(1-b2) = 3.2 lr).
            # EMA: ema' = d ema + (1 - d) p', so it moves by (1 - d) of (p' - ema).
            d = TRAIN_EMA
            ema_err = max(float((new.ema_params[k] - (d * e + (1 - d) * new.params[k])).abs().max())
                          for k, e in state.ema_params.items())
            ema_moved = max(float((new.ema_params[k] - e).abs().max()) for k, e in state.ema_params.items())
            ulp = 2.0**-23 * max(float(p.abs().max()) for p in new.params.values())  # fp32 spacing at the largest
            grads_dtypes = sorted({str(p.dtype) for p in new.params.values()})
            ok = (counts == expect and math.isfinite(loss) and 0.0 < moved <= 4.0 * TRAIN_LR
                  and ema_err <= 1e-7 and 0.0 < ema_moved <= 4.0 * TRAIN_LR * (1 - d) * (i + 1) + ulp
                  and new.step == state.step + 1 and grads_dtypes == ["torch.float32"])
            rec = {"phase": "train", "precision": precision, "remat": remat, "step": i, "batch": BATCH,
                   "size": SIZE, "launches": counts, "loss": loss, "ms": ms, "param_max_move": moved,
                   "ema_max_move": ema_moved, "ema_identity_max_err": ema_err, "master_dtypes": grads_dtypes,
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30, "ok": ok}
            emit(rec)
            if not ok:
                raise AssertionError(f"training step failed its checks (expected launches {expect}): {rec}")
            state = new

    # One more step of each policy (remat off) under the profiler: where the step's time goes.
    for precision in ("bfloat16", "float32"):
        profile_step(torch, unet, sched, batch, precision)
    return totals


def profile_step(torch, unet, sched, batch, precision):
    """One traced training step after two warm ones (``train_profile``): device busy time, idle share and
    the largest kernels."""
    from mrisr_torch.train.precision import get_policy
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_resdiff_train_step, step_generator

    state = create_train_state(unet, make_optimizer(TRAIN_LR), ema_decay=TRAIN_EMA)
    step = make_resdiff_train_step(unet, sched, get_policy(precision))
    state, _ = step(state, batch, step_generator(6, 0, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch, step_generator(6, 1, "cuda"))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    rec = profile_chain(torch, lambda: step(state, batch, step_generator(6, 2, "cuda")), step_ms,
                        ranges=("group_norm_silu_backward",))
    emit({"phase": "train_profile", "precision": precision, "step_ms": step_ms, **rec})


def phase_grad(torch):
    """One fp32 step's gradients: the card's kernels against the CPU's plain versions, at full width and
    for the parity harness's UNet."""
    check_gradients(torch, dict(image_size=GRAD_SIZE), 7, TRAIN_LAUNCHES)
    check_gradients(torch, NARROW, 17, NARROW_LAUNCHES)


def check_gradients(torch, unet_kwargs, seed, expect):
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.ops import launch_counts, reset_launch_counts
    from mrisr_torch.train.state import Optimizer, create_train_state
    from mrisr_torch.train.steps import make_resdiff_train_step

    size = unet_kwargs["image_size"]
    torch.manual_seed(seed)
    gpu = ResDiffUNet(**unet_kwargs, dropout=0.0)
    cpu = ResDiffUNet(**unet_kwargs, dropout=0.0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    sched = resdiff_schedule(1000)
    batch = _synthetic_batch(torch, 1, size, seed + 1, "cpu")
    gen = torch.Generator().manual_seed(seed + 2)
    draws = {"gamma": torch.tensor([0.6]), "eps": torch.randn((1, 1, size, size), generator=gen)}

    def gradients(unet, device):
        seen = {}

        def record(grads, opt_state, params):  # an optimizer that keeps the gradients and moves nothing
            seen.update(grads)
            return {k: torch.zeros_like(g) for k, g in grads.items()}, opt_state

        state = create_train_state(unet, Optimizer(lambda params: {}, record), device=device)
        step = make_resdiff_train_step(unet, sched, device=device)
        on = lambda tree: {k: v.to(device) for k, v in tree.items()}  # noqa: E731
        t0 = time.perf_counter()
        _, metrics = step(state, on(batch), None, on(draws))
        loss = float(metrics["loss"])
        return {k: g.cpu() for k, g in seen.items()}, loss, time.perf_counter() - t0

    reset_launch_counts()
    g_gpu, loss_gpu, _ = gradients(gpu, "cuda")
    counts = launch_counts()
    g_cpu, loss_cpu, cpu_s = gradients(cpu, "cpu")
    rel = {k: float((g_gpu[k] - g).norm() / g.norm().clamp_min(1e-30)) for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    ok = (rel[worst] <= GRAD_TOL and counts == expect and launch_counts() == counts
          and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu))
    rec = {"phase": "grad", "unet": unet_kwargs, "shape": [1, size, size, 1], "dtype": "float32", "tf32": False,
           "dropout": 0.0, "launches": counts, "loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "leaves": len(rel),
           "worst_leaf": worst, "worst_rel_l2": rel[worst], "tolerance": GRAD_TOL, "cpu_step_s": cpu_s, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"gradients on the card disagree with the CPU plain path: {rec}")


KERNELS = [  # (name, route, source, the TPU kernel it replaces)
    ("flash_attention_fwd", "cuda", "mrisr_torch/csrc/flash_attn_fwd.cu", "mrisr_tpu/ops/flash_attention.py:98"),
    ("flash_attention_bwd_dq", "cuda", "mrisr_torch/csrc/flash_attn_bwd.cu", "mrisr_tpu/ops/flash_attention.py:228"),
    ("flash_attention_bwd_dkv", "cuda", "mrisr_torch/csrc/flash_attn_bwd.cu", "mrisr_tpu/ops/flash_attention.py:262"),
    ("group_norm_silu", "cuda", "mrisr_torch/csrc/group_norm_silu.cu", "mrisr_tpu/ops/groupnorm.py:57"),
]


def summary(recs, chain_totals, train_totals):
    """The kernels line: launches are those of the main paths (serving chains and training steps)."""
    entries = []
    for name, route, source, replaces in KERNELS:
        main = next(r for r in recs[name] if "ms" in r and r["dtype"] == "bfloat16")  # heaviest main-path shape
        entries.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": chain_totals[name] + train_totals[name], "launches_serving_chains": chain_totals[name],
            "launches_training_steps": train_totals[name], "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "device_ms": main.get("device_ms"),
            "case": main["case"], "shape": main["shape"],
            "dtype": main["dtype"], "max_abs_err_all_checks": max(r["max_abs_err"] for r in recs[name])})
    return {"kernels": entries}


PHASES = ("kernel", "chain", "forward", "train", "grad")


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s; the kernels line needs kernel, chain and train")
    parser.add_argument("--log", help="also write every JSON line to this file")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phase in {phases}")
    if args.log:
        global LOG
        LOG = open(args.log, "w")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import mrisr_torch  # noqa: F401  (fails outside a checkout of the repository)

    # Every fp32 comparison below is in full fp32: cuDNN convolutions would
    # otherwise run in TF32 by default.  bf16 work is unaffected.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = phase_device(torch)
    phase_build(torch)
    recs = phase_kernels(torch) if "kernel" in phases else None
    chain_totals = phase_chain(torch) if "chain" in phases else None
    if "forward" in phases:
        phase_forward(torch)
    train_totals = phase_train(torch) if "train" in phases else None
    if "grad" in phases:
        phase_grad(torch)
    if recs and chain_totals and train_totals:
        emit(summary(recs, chain_totals, train_totals))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
