#!/usr/bin/env python3
"""Drive the PyTorch port (``mrisr_torch``) on one NVIDIA GPU and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``.  It builds the
kernels from the sources in the checkout (``nvcc`` for the CUDA flash
attention, Triton for GroupNorm+SiLU), so nothing else needs to be built
first.  It needs one CUDA card; without one, or when any phase fails, it
exits non-zero and prints no result.  Each phase prints one JSON line:

1. ``device``: the card, and its name and power limit from nvidia-smi;
2. ``build``: seconds to build each kernel, and the ptxas register report;
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the serving chain's shapes, in bf16 and fp32 (plus ragged shapes), with
   its time beside its bound, the plain version's time and one PyTorch
   library call's time (timed only; the port never calls it);
4. ``chain``: the full-width 256^2, bs-8, bf16, 50-step ResDiff serving chain
   through ``ResDiffPipeline.super_resolve``, in the fast (ca_kv_pool=8) and
   exact (ca_kv_pool=0) profiles, with the kernels' launch counts checked,
   then one more chain of each profile traced with ``torch.profiler``
   (``profile``: the device's busy time, idle share and largest kernels);
5. ``forward``: one full-width bs-1 fp32 UNet forward on the card (TF32 off)
   against the plain path on the CPU.

Then the kernels summary line, the nvidia-smi line, and last the result line.
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
FLASH_RAGGED = [("ragged", 2, 1000, 777, 32), ("ragged", 1, 333, 4097, 64), ("ragged", 3, 130, 70, 128)]
GN_CASES = [  # (case, shape, groups): the chain's largest and smallest ConvBlock heads
    ("largest", (BATCH, 96, 256, 256), 16),
    ("smallest", (BATCH, 128, 32, 32), 16),
]
GN_RAGGED = [("ragged", (3, 24, 17, 19), 4), ("ragged", (1, 6, 5, 7), 3), ("ragged", (2, 512, 3, 5), 16)]
# Stated before the run.  O is held to what it is compared with: each element
# within o_atol_rms * rms(ref) + o_rtol * |ref|, and rms(err) within
# o_rms_rel * rms(ref).  Over 16384 keys a typical |O| is only ~0.013, so a
# fixed atol would pass a wrong P.V.  bf16: the kernel rounds p to bf16 for
# the PV product and its denominator (2^-9 relative) and both sides round O to
# bf16 (one ulp is 2^-8 relative); fp32: exp2f's 2-ulp error and a different
# summation order.
FLASH_TOL = {"bfloat16": dict(o_atol_rms=5e-2, o_rtol=2e-2, o_rms_rel=1e-2, lse_atol=1e-2),
             "float32": dict(o_atol_rms=1e-3, o_rtol=1e-4, o_rms_rel=1e-4, lse_atol=1e-4)}
# bf16: one output ulp (2^-8 relative) either way; fp32: E[x^2]-mean^2 vs two-pass variance.
GN_TOL = {"bfloat16": dict(atol=3e-2, rtol=1e-2), "float32": dict(atol=1e-4, rtol=1e-4)}
# Full forward, fp32 with TF32 off: the North-star forward bar.
FORWARD_TOL = dict(atol=2e-4, rtol=1e-3)


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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


def phase_build(torch):
    import triton

    from mrisr_torch import _build
    from mrisr_torch.ops import flash_attention, groupnorm

    t0 = time.perf_counter()
    flash_attention.build()
    t1 = time.perf_counter()
    groupnorm.build()
    t2 = time.perf_counter()
    log = (_build.build_dir() / "flash_attn_fwd.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "flash_attn_fwd_nvcc_s": t1 - t0, "group_norm_silu_triton_s": t2 - t1,
          "triton": triton.__version__, "ptxas": ptxas})


def check_flash(torch, F, dtype, case, b, n, m, d, timed):
    from mrisr_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(b * 7 + n + m + d)
    q, k, v = (torch.randn((b, s, d), generator=gen, device="cuda").to(dtype) for s in (n, m, m))
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
        flops = 4.0 * b * n * m * d
        rec["bound_ms"], rec["bound_by"] = bound(
            n_bytes, flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
        rec["exp_floor_ms"] = b * n * m / PEAK_EXPS * 1e3
        rec["ms"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale))
        rec["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, scale), max_iters=10)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]  # [B, 1 head, N, D]: fused backends take 4-D
        rec["library_ms"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), max_iters=10)
    emit(rec)
    if not ok:
        raise AssertionError(f"flash attention disagrees with its plain version: {rec}")
    return rec


def check_gn(torch, F, dtype, case, shape, groups, timed):
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
        rec["ms"] = cuda_ms(torch, lambda: gn.group_norm_silu(x, w, bias, groups, 1e-5))
        rec["plain_ms"] = cuda_ms(torch, lambda: gn.group_norm_silu_plain(x, w, bias, groups, 1e-5))
        rec["library_ms"] = cuda_ms(torch, lambda: F.silu(F.group_norm(x, groups, w, bias, 1e-5)))
    emit(rec)
    if not ok:
        raise AssertionError(f"group_norm_silu disagrees with its plain version: {rec}")
    return rec


def phase_kernels(torch):
    import torch.nn.functional as F

    flash, gn = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for case in FLASH_CASES:
            flash.append(check_flash(torch, F, dtype, *case, timed=True))
        for case in FLASH_RAGGED:
            flash.append(check_flash(torch, F, dtype, *case, timed=False))
        for case in GN_CASES:
            gn.append(check_gn(torch, F, dtype, *case, timed=True))
        for case in GN_RAGGED:
            gn.append(check_gn(torch, F, dtype, *case, timed=False))
    return flash, gn


def profile_chain(torch, run, chain_ms, top=12):
    """Device time of one chain by kernel, from ``torch.profiler``.

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
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / chain_ms,
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
    expect = {"flash_attention_fwd": n_sites * STEPS, "group_norm_silu": n_gn * STEPS}
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
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    torch.manual_seed(2)
    gpu = ResDiffUNet(image_size=SIZE, device="cuda")
    cpu = ResDiffUNet(image_size=SIZE, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 2, SIZE, SIZE), generator=gen)
    gamma = torch.tensor([0.7])
    with torch.no_grad():
        reset_launch_counts()
        out_gpu = gpu(x.cuda(), gamma.cuda()).cpu()
        counts = launch_counts()
        t0 = time.perf_counter()
        out_cpu = cpu(x, gamma)
        cpu_s = time.perf_counter() - t0
    err = (out_gpu - out_cpu).abs()
    ok = bool((err <= FORWARD_TOL["atol"] + FORWARD_TOL["rtol"] * out_cpu.abs()).all())
    rec = {"phase": "forward", "shape": [1, 2, SIZE, SIZE], "dtype": "float32", "tf32": False,
           "launches": counts, "max_abs_err": float(err.max()), "ref_abs_max": float(out_cpu.abs().max()),
           "tolerance": FORWARD_TOL, "cpu_forward_s": cpu_s, "ok": ok}
    emit(rec)
    if not ok or counts != {"flash_attention_fwd": 2, "group_norm_silu": 29}:
        raise AssertionError(f"full forward on the card disagrees with the CPU plain path: {rec}")


def summary(flash, gn, totals):
    def entry(name, route, source, replaces, recs):
        main = next(r for r in recs if "ms" in r and r["dtype"] == "bfloat16")  # heaviest main-path shape
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": totals[name], "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "case": main["case"], "shape": main["shape"],
                "dtype": main["dtype"], "max_abs_err_all_checks": max(r["max_abs_err"] for r in recs)}

    return {"kernels": [
        entry("flash_attention_fwd", "cuda", "mrisr_torch/csrc/flash_attn_fwd.cu",
              "mrisr_tpu/ops/flash_attention.py:98", flash),
        entry("group_norm_silu", "triton", "mrisr_torch/ops/groupnorm.py",
              "mrisr_tpu/ops/groupnorm.py:57", gn),
    ]}


def main() -> int:
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
    flash, gn = phase_kernels(torch)
    totals = phase_chain(torch)
    phase_forward(torch)
    emit(summary(flash, gn, totals))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
