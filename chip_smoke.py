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
   D = 32, 64, 128, the fp32 forward, dQ and dK/dV at D = 40, and the bf16
   forward's resident form at D = 32, from ``cuobjdump -sass`` (none of the
   22 may be 0);
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 and fp32 (plus ragged shapes, ragged
   shapes where every score is below -100, each also at D = 40, and head
   widths the kernels pad: D = 16, 36 and, in bf16 and for fp32 dQ, 40; there
   fp32 dQ bitwise equal to the dQ of the padded inputs), with its time
   beside its bound, the plain version's time
   and one PyTorch library call's time (timed only; the port never calls
   it); the kernel's own device time (``torch.profiler``) and the wrapper's
   host microseconds per call, and the library call's device time; for fp32
   a tensor-core (3xTF32) bound beside the FMA bound and the device time of
   the 3xTF32 operand prep (the forward's also with its prep); the
   forward's (both forms of the bf16 one: ``FLASH_RESIDENT`` crosses batches
   inside a CTA's run) and the backward's results bitwise equal over two
   calls, each case's worst share of its limit; gradients through
   the autograd function against the direct backward call; GroupNorm+SiLU
   at all 13 shapes of the UNet;
4. ``chain``: the full-width 256^2, bs-8, bf16, 50-step ResDiff serving chain
   through ``ResDiffPipeline.super_resolve``, in the fast (ca_kv_pool=8) and
   exact (ca_kv_pool=0) profiles, as a captured CUDA graph (the first call
   warms up, captures and replays) and eagerly: their bitwise agreement
   (also from one generator), wall and CUDA-event ms of each; then one
   traced chain of each mode (``profile``: the device's busy time, idle
   share, largest kernels, the kernels counted in the trace, and for the
   replay the graph's kernel nodes, which give its launches);
5. ``checkpoint``: the trained checkpoint ``ckpt_256_r3.msgpack`` read by the
   port's msgpack reader, its EMA UNet's fp32 eps against the JAX package's
   stored one (``PARITY_TORCH_CKPT_ref.npz``, from
   ``tools/torch_ckpt_chain.py``), the fp32 50-step chains in both profiles
   held to 0.01 dB per image against the stored JAX chains' PSNR, then the
   bf16 serving chains (PSNR and SSIM, and the stored JAX bf16 chains' PSNR
   beside them, for information);
6. ``volume``: a synthetic 220x220x40 NIfTI through ``super_resolve_volume``
   at 256^2, bs 8, bf16, 50 steps, grouped (G=2) and serial, both graphed:
   equal volumes, seconds per volume and slices per second (written as
   uncompressed NIfTI; the gzipped write timed apart), one traced volume of
   each mode;
7. ``ddpm``: one full-length (1000-step) ancestral chain at bs 8, bf16,
   fast profile, run eagerly;
8. ``latent``: the latent SD1.5 family at SD1.5's widths (random weights from
   fixed seeds, 77x768 context, bf16 weights, 20 Res-SRDiff steps; as in the
   reference the carry is fp32 from the shifted start, so the UNet, ControlNet
   and decoder compute in fp32) through ``LatentSRPipeline.super_resolve``:
   ControlNet mode (the towers fused, the default) at 512^2 (bs 8), graphed and eager (graph = eager bitwise,
   also from one generator), and at 1024^2 (bs 2), graphed; wall ms (a
   graphed chain's from its traced replay, the eager chain's from its counted
   call), slices/s, peak memory; one traced chain of each mode, the
   replay's launches from the graph's kernel nodes, held to the counts the
   modules give: B3 950 at both sizes, B1 0 at 512^2 and 100 at 1024^2; one
   graphed adapter-mode chain at 512^2 (B3 950); one fp32 ControlNet+UNet
   evaluation at 576^2, bs 1, against the CPU's plain path (rms error within
   1e-4 of rms(ref)); B3 at every head shape of the 512^2 chain (collected
   from the modules while the eager chain runs) and B1 at the SD route as the
   fused 1024^2 chain launches it (32 x 16384^2, D=40, padded to 64 in bf16),
   both dtypes, and at its up-tower sites (16 x 16384^2, fp32), against their
   plain versions, timed beside their bounds and one library call (the kernel
   phase adds B2a and B2b there, fp32, 16 and 8 x 16384^2: the fused training
   step's);
9. ``latent_train``: the latent family's training steps
   (``mrisr_torch/train/latent.py``) at SD1.5's widths, fp32 weights and
   states: ControlNet+LoRA at 256^2, bs 2, from pixels, graphed against eager
   over 3 steps (bitwise under deterministic cuDNN), and ControlNet mode at
   1024^2, bs 1, from cached latents, graphed; ms a step, peak memory, ten
   traced replays each, their launches from the graph's kernel nodes held to
   what the modules give (the towers fused: B3 87 and 45 a step; B1 5, B2a 5, B2b 5 at 1024^2);
   B3 in fp32 against its plain version at every head shape the two steps
   gave it; one ControlNet step's gradients at 576^2 against the CPU's plain
   path; and ``train-latent`` in this process at 256^2, bs 2, traced whole:
   ControlNet mode for 30 steps, the LoRA and adapter modes for 2 each;
10. ``forward``: one full-width bs-1 fp32 UNet forward on the card (TF32 off)
   against the plain path on the CPU, and the same for the reference's
   parity-harness UNet (128^2, inner 16, 8 norm groups), whose 64^2
   cross-attention has heads of D=16 (padded to 32);
11. ``train``: full-width training steps (256^2, bs 8, dropout 0.2, Adam 1e-5,
   EMA 0.999) through ``make_resdiff_train_step`` in fp32, bf16 and bf16 with
   remat: the graphed step (one CUDA graph a step) against the eager step, 3
   steps each from one state and the same generators (losses, parameters,
   EMA, optimizer state and generator states bitwise equal; cuDNN
   deterministic), parameter and EMA movement, fp32 masters, ms and peak
   memory; the graph's kernel nodes (2 / 2 / 2 / 29 a step; remat 4 / 2 / 2
   / 58) and one traced replay and one traced eager step of each policy
   (``train_profile``: wall, busy and idle share side by side);
12. ``cli``: ``python -m mrisr_torch.cli`` in this process at 256^2, bs 8:
   ``train-cnn``, ``train-resdiff`` (bf16, 30 steps, validation through the
   graphed pipeline on the EMA weights) and ``--resume`` (5 more),
   ``build-cache`` and ``train-resdiff --cache``, ``sr-volume`` on a
   220x220x40 NIfTI with the checkpoint just written; each trainer's steps/s,
   batch-making and waiting time against the step's device time; one traced
   replay of the trainer's step and of the volume's chain (their launches);
13. ``grad``: one full-width bs-1 fp32 step's gradients on the card (TF32 off,
   dropout 0, kernels on) against the CPU plain path, per parameter; and
   the same for the parity-harness UNet;
14. ``bench``: ``python3 -m mrisr_torch.bench`` (fast and exact profiles, 3
   timed calls each, and ``--pipeline latent``) in a subprocess, its JSON line echoed;
15. ``prep`` (run after ``latent_train``): the workflow around the model with
   no JAX.  (a) An SDUNet at SD1.5's widths cut to three levels and one
   ResnetBlock2D a down block (``PREP_UNET_CUT``: its one-core ``.npz`` write
   set the phase's length at full depth) and the AutoencoderKL (fp32, fixed seeds) exported to
   diffusers-named ``.safetensors`` and through ``convert-weights`` to the
   reference's ``.npz`` (seconds to read, convert and write);
   ``train-latent --weights-dir`` (ControlNet of the cut UNet's shape, fused,
   256^2, bs 2, 2 steps) traced whole, the UNet (built at the tree's depth)
   and the VAE it read from the ``.npz`` files each bitwise equal to its
   original; a bf16 ``LatentSRPipeline`` on them (the cut UNet) serving a 256x256x8 NIfTI at bs 4, serially
   and two batches a call (equal volumes, seconds per volume, one traced
   volume of each).  (b) A BIDS tree of two subjects (64 mT 146x182x36, 3 T
   176x240x256): ``stats``, ``report``, ``preprocess-slices`` and
   ``evaluate`` on the card, ``export-png``; ``build-index`` over two
   DICOM patients x 16 slices; seconds and output counts of each.  (c) One
   pair on the 3 T grid, the LR under a known motion and a bias field,
   through ``SliceDataset(do_n4=True)`` (N4 cut to ``PREP_N4_ITERATIONS``
   iterations) with the rigid registration on the
   card: N4 and registration seconds, the 6 parameters against the motion
   (``PREP_MOTION_TOL``) and against the CPU's (``PREP_CPU_TOL``); on a
   thread beside (a) and (b), its registration after them.
16. ``parity`` (run after ``cli``): the fidelity harness and the MNIST trainer through the command line in
   this process, fp32.  (a) ``parity`` at PARITY_r07_256.json's configuration (256^2, inner 32, bs 8,
   cosine, EMA 0.999, seeds 2 and 3, chains of 10, 50 and 250 steps, the MNIST leg on), depth cut as
   ``PARITY_CUTS`` names (the longest chain 100 steps among them): seconds a leg, ms a training step (its
   graph's capture included), seconds a chain by profile and length, the report's rows; each 50-step
   chain's starting noise bitwise the exact profile's; one traced replay a profile (B1 100, B3 1450 from
   the graph's nodes).  The stage-2 loop (``train_phantom_resdiff``) resumed from its ``--ckpt`` equals the
   uninterrupted run bitwise (4 steps, deterministic cuDNN; the resumed run traced whole: B1, B2a, B2b 2 and
   B3 29 a step).  (b)
   ``parity-latent`` at PARITY_r09.json's widths (256^2, VAE 32, UNet 64, cached latents, x0 prediction,
   20 steps, every leg on), cut as ``PARITY_LATENT_CUTS`` names: no B1 (every attention dense at 4096
   keys).  (c) ``train-mnist`` in both modes and the ddpm run resumed (traced whole: B3 15 a step), bitwise
   against an uninterrupted run.  B3, B1 and the B2 pair against their plain versions at every (shape,
   dtype) the legs launched them at, recorded by the wrappers (``ops.recording_shapes``).
17. ``tail`` (run after ``parity``): the port's last modules.  (a) The fused ControlNet+UNet encoder towers
   (``models/fused.py``, the default form of every ControlNet chain and step above) against the towers one
   after the other: one fp32 eps-prediction at 512^2, bs 2 (``TAIL_EPS_TOL``, B3 45 against 65); the graphed
   512^2 bs-8 and 1024^2 bs-2 chains of phase ``latent`` unfused (ms and launches of a traced replay: B3
   1350, B1 0 / 140) against its fused ones (B3 950, B1 0 / 100), outputs within ``TAIL_CHAIN_TOL``; the
   1024^2 ControlNet training step from cached latents in both forms (graphed, traced replays: ms, B1 5 / 7,
   B2a and B2b 5, B3 45 / 65 a step; one eager step of each, gradients within ``TAIL_GRAD_TOL``).  (b) ``int8_conv`` on the card
   bitwise equal to its plain version on the CPU at every int8 conv shape of the bs-8 256^2 UNet (each timed
   beside the exact bf16 conv); the bs-8 bf16 fast chain with ``conv_int8`` graphed (traced replays: B1 100,
   B3 1450 a chain; ms beside the same chain with exact convs); the int8 profile on the trained checkpoint against
   exact, one eager fp32 chain each, PSNR per image (information).  (c) The five mesh legs of ``parallel/dryrun.py`` in this process at
   world size 1 over NCCL, each held to its no-mesh result (the graphed data-parallel step with its
   all-reduce captured).  (d) SDXL's text towers at full width (ViT-L 768 x 12, bigG 1280 x 32; fp32) on
   two prompts, card against CPU (``SDXL_TOL``).  Then B1, the B2 pair and B3 against their plain versions
   at every (shape, dtype) the legs launched them at, and B3 timed at the fused towers' heads (2 x 32
   groups).

Each phase's seconds follow it (``"phase": "seconds"``).  Each main path (chain, checkpoint, volume, ddpm,
latent, latent_train, prep, train, cli, parity, tail) is driven with
the kernels' launch counts set to 0 just before it and read just after.  A
replayed CUDA graph calls no wrapper: a graphed path (chain, checkpoint,
volume, latent, latent_train, prep, train, cli, parity) is traced, its wrappers' counts must stay 0, and its
launches are the captured graph's kernel nodes times the graph launches in the
trace, held equal to what the path must launch (``replayed``).  Phase ``tail``
counts its wrappers' launches (eager runs and captures) and adds each graph's
kernel nodes, read through libcuda's graph calls and held to what the modules give,
times its replays, without a trace.
Then the kernels summary line, the nvidia-smi line, and last the result line.
``--phases a,b`` runs only the named phases (device and build always run);
``--log FILE`` also writes every JSON line to FILE.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import gc
import json
import math
import subprocess
import sys
import threading
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
                ("ragged", 2, 37, 5, 32), ("ragged", 2, 300, 1000, 64),
                # bf16 D=32 past RESIDENT_MAX_KEYS: the tiled form's masked last tile and partial Q tile
                ("ragged", 2, 1000, 1537, 32),
                # SD1.5's 40-wide heads (fp32 B1, B2a and B2b take them unpadded, with a tail box a row): N not a
                # multiple of 128, M not one of 64, and M below one tile
                ("ragged", 3, 130, 70, 40), ("ragged", 2, 37, 5, 40)]
# Ragged shapes where every score is below -100 (extreme_qk): a zero key past
# M would score 0 and get p = exp(-lse), which overflows.
FLASH_EXTREME = [("extreme", 2, 300, 1000, 64), ("extreme", 2, 1000, 777, 32), ("extreme", 2, 300, 1000, 40),
                 ("extreme", 2, 1000, 1537, 32)]
# The bf16 forward's resident form (M up to ops.flash_attention.RESIDENT_MAX_KEYS) where one CTA's run of Q
# tiles crosses a batch: more Q tiles than SMs at B >= 3, M not a multiple of 128, N not one of 128; forward
# only (no path runs the backward at such shapes).
FLASH_RESIDENT = [("ragged", 3, 16461, 300, 32), ("ragged", 4, 9000, 77, 32), ("ragged", 3, 16461, 1000, 32),
                  ("extreme", 3, 16461, 300, 32)]
# Head widths the kernels do not have: the wrappers pad D to 32, and 36 to 40 (fp32) or 64 (bf16); bf16 pads
# 40 to 64.
FLASH_PAD = [("pad", 2, 4096, 4096, 16), ("pad", 2, 1000, 777, 40), ("pad", 2, 1000, 777, 36)]
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
EMIT_LOCK = threading.Lock()  # phase ``prep`` emits from three threads


def emit(obj):
    line = json.dumps(obj)
    with EMIT_LOCK:
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
    # D = 32, 64, 128, the fp32 forward, dQ and dK/dV at D = 40, and the bf16
    # forward's resident form at D = 32 -- is built on wgmma: the SASS of each
    # of the 22 must hold HGMMA instructions.
    hgmma = {k: n for lib in flash_attention.LIBRARIES
             for k, n in sass_counts(_build.build_dir() / f"lib{lib}.so", "HGMMA").items()
             if k.startswith(("flash_fwd_", "flash_bwd_"))}
    emit({"phase": "build", "nvcc_s": t1 - t0, "sources": list(libraries),
          "kernels_with_spills": spills, "flash_hgmma": hgmma, "ptxas": ptxas})
    # ptxas notes a wgmma pipeline it had to serialize (the design's overlap lost).
    serialized = [ln for lines in ptxas.values() for ln in lines if "Performance Loss" in ln]
    if len(hgmma) != 22 or not all(hgmma.values()) or any(spills.values()) or serialized:
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
    o2, lse2 = fa.flash_attention_fwd(q, k, v, scale)  # no atomics, a fixed order: the same bits again
    ro, rlse = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2))
    name = str(dtype).split(".")[-1]
    tol = FLASH_TOL[name]
    ref = ro.float()
    rms_ref = float(ref.square().mean().sqrt())
    o_err = (o.float() - ref).abs()
    o_limit = tol["o_atol_rms"] * rms_ref + tol["o_rtol"] * ref.abs()
    rms_err_rel = float(o_err.square().mean().sqrt()) / rms_ref
    lse_err = (lse - rlse).abs()
    ok = (bool((o_err <= o_limit).all()) and rms_err_rel <= tol["o_rms_rel"]
          and bool((lse_err <= tol["lse_atol"]).all()) and bitwise)
    kd = fa.kernel_head_dim(d, dtype)
    shares = {"o_err_over_limit": float((o_err / o_limit).max()),
              "rms_err_over_limit": rms_err_rel / tol["o_rms_rel"],
              "lse_err_over_limit": float(lse_err.max()) / tol["lse_atol"]}
    rec = {"phase": "kernel", "kernel": "flash_attention_fwd", "case": case, "dtype": name,
           "shape": [b, n, m, d], "form": fa.fwd_form(m, kd, dtype), "max_abs_err": float(o_err.max()),
           "o_atol": tol["o_atol_rms"] * rms_ref, **shares, "worst_share": max(shares.values()), "ref_rms": rms_ref,
           "rms_err_rel": rms_err_rel, "lse_max_abs_err": float(lse_err.max()),
           "max_rel_err": float(o_err.max() / ref.abs().max()), "bitwise_repeat": bitwise, "tolerance": tol,
           "ok": ok}
    if timed:
        size = q.element_size()
        n_bytes = (2 * b * n * d + 2 * b * m * d) * size + 4 * b * n
        set_bounds(rec, n_bytes, 4.0 * b * n * m * d, dtype == torch.bfloat16)
        rec["exp_floor_ms"] = b * n * m / PEAK_EXPS * 1e3
        rec["ms"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale))
        # The kernel alone (device time) and the wrapper's host time per call:
        # where ms is near host_us and well above device_ms, the wrapper sets the time.
        rec["device_ms"] = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), "flash_fwd_")
        # fp32 makes its operands first (some 20 launches a call), and a padded head adds its copies: few
        # calls, so the launch queue never fills and the enqueue is not held back by the device.
        rec["host_us"] = host_us(torch, lambda: fa.flash_attention_fwd(q, k, v, scale),
                                 iters=200 if dtype == torch.bfloat16 and d == fa.kernel_head_dim(d, dtype) else 20)
        rec["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, scale), max_iters=10)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]  # [B, 1 head, N, D]: fused backends take 4-D
        run_library = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
        rec["library_ms"] = cuda_ms(torch, run_library, max_iters=10)
        rec["library_device_ms"] = device_ms(torch, run_library, None, iters=10)
        if dtype == torch.float32:  # the 3xTF32 operands are made in every call: "fwd with prep"
            rec["prep_device_ms"] = device_ms(torch, lambda: fa.tf32_fwd_parts(q, k, v), None)
            rec["with_prep_device_ms"] = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, scale), None)
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
    delta = (do.float() * o.float()).sum(dim=-1)
    # A head that reaches B2a at D=40 (fp32): its dQ against the D=64 kernel's on the inputs zero-padded to
    # 64, the route of earlier trees, within the same limit (another tile of keys sums in another order).
    kd = fa.kernel_head_dim(d, dtype, "dq")  # dK/dV's too
    padded_dq = None
    if kd == 40:
        padded = [fa._pad_head_dim(t, 64) for t in (q, k, v, do)]
        padded_dq = fa.flash_attention_bwd_dq(*padded, lse, delta, scale)[..., :d]
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    name = str(dtype).split(".")[-1]
    tol = FLASH_BWD_TOL[name]

    def error(g, ref):
        ref = ref.float()
        rms_ref = float(ref.square().mean().sqrt())
        err = (g.float() - ref).abs()
        limit = tol["atol_rms"] * rms_ref + tol["rtol"] * ref.abs()
        rec = {"max_abs_err": float(err.max()), "err_over_limit": float((err / limit).max()),
               "ref_rms": rms_ref, "rms_err_rel": float(err.square().mean().sqrt()) / rms_ref}
        return rec, bool(torch.isfinite(g).all()) and rec["err_over_limit"] <= 1.0 and rec["rms_err_rel"] <= tol["rms_rel"]

    errs, ok = {}, deterministic
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[key], within = error(g, w)
        ok = ok and within
    base = {"phase": "kernel", "case": case, "dtype": name, "shape": [b, n, m, d], "tolerance": tol,
            "deterministic": deterministic, "kernel_d": kd, "ok": ok}
    if padded_dq is not None:
        base["dq_vs_padded_route"], within = error(got[0], padded_dq)
        base["ok"] = ok = ok and within
    recs = {"flash_attention_bwd_dq": {**base, "kernel": "flash_attention_bwd_dq", "errors": {"dq": errs["dq"]},
                                       "max_abs_err": errs["dq"]["max_abs_err"]},
            "flash_attention_bwd_dkv": {**base, "kernel": "flash_attention_bwd_dkv",
                                        "errors": {"dk": errs["dk"], "dv": errs["dv"]},
                                        "max_abs_err": max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])}}
    if timed:
        size = q.element_size()
        bf16 = dtype == torch.bfloat16
        dq_rec, dkv_rec = recs["flash_attention_bwd_dq"], recs["flash_attention_bwd_dkv"]
        # Each input read once, each output written once; three products for dQ, four for dK/dV.
        set_bounds(dq_rec, (3 * b * n * d + 2 * b * m * d) * size + 8 * b * n, 6.0 * b * n * m * d, bf16)
        set_bounds(dkv_rec, (2 * b * n * d + 4 * b * m * d) * size + 8 * b * n, 8.0 * b * n * m * d, bf16)
        # The kernels alone, on heads zero-padded to the kernels' width as the pair pads them (bf16 D=40 -> 64);
        # fp32 on 3xTF32 operands made once (the pair makes its own).  The bounds count the unpadded work.
        qp, kp, vp, dop = (fa._pad_head_dim(t, kd) for t in (q, k, v, do))
        parts = None if bf16 else fa.tf32_parts(qp, kp, vp, dop)
        prep = lambda: fa.tf32_parts(qp, kp, vp, dop)  # noqa: E731  (the pair's 3xTF32 operands)
        run_dq = lambda: fa.flash_attention_bwd_dq(qp, kp, vp, dop, lse, delta, scale, parts)  # noqa: E731
        run_dkv = lambda: fa.flash_attention_bwd_dkv(qp, kp, vp, dop, lse, delta, scale, parts)  # noqa: E731
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
            pair["prep_device_ms"] = device_ms(torch, prep, None)
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


def check_gn(torch, F, dtype, case, shape, groups, timed, backward=False, eps=1e-5, brief=False):
    """B3 against its plain version at ``shape``; when ``timed``, its time beside its bound (x read once,
    y written once; ``reread_bound_ms`` with x read twice where the plan keeps no slice in shared memory),
    the plain version's and one library call's (``F.silu(F.group_norm)``).  ``brief``: each timed over 50
    ms (not 200), 50 host calls (not 200), no device times from the profiler."""
    from mrisr_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + groups)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    y = gn.group_norm_silu(x, w, bias, groups, eps)
    ref = gn.group_norm_silu_plain(x, w, bias, groups, eps)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tol = GN_TOL[name]
    err = (y.float() - ref.float()).abs()
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    ok = bool((err <= limit).all())
    rec = {"phase": "kernel", "kernel": "group_norm_silu", "case": case, "dtype": name,
           "shape": list(shape), "groups": groups, "eps": eps, "max_abs_err": float(err.max()),
           "err_over_limit": float((err / limit).max()),
           "max_rel_err": float(err.max() / ref.float().abs().max()), "tolerance": tol, "ok": ok}
    if timed:
        numel = x.numel()
        plan = gn.gn_plan(tuple(shape), groups, x.element_size())
        n_bytes = 2 * numel * x.element_size() + 2 * c * w.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 10.0 * numel, PEAK_FP32_FLOPS)
        if not plan.resident:
            rec["reread_bound_ms"] = bound(n_bytes + numel * x.element_size(), 10.0 * numel, PEAK_FP32_FLOPS)[0]
        run = lambda: gn.group_norm_silu(x, w, bias, groups, eps)  # noqa: E731
        run_library = lambda: F.silu(F.group_norm(x, groups, w, bias, eps))  # noqa: E731
        rec["plan"] = plan._asdict()
        min_ms = 50.0 if brief else 200.0
        rec["ms"] = cuda_ms(torch, run, min_ms)
        rec["host_us"] = host_us(torch, run, iters=50 if brief else 200)
        rec["plain_ms"] = cuda_ms(torch, lambda: gn.group_norm_silu_plain(x, w, bias, groups, eps), min_ms)
        rec["library_ms"] = cuda_ms(torch, run_library, min_ms)
        if not brief:
            rec["device_ms"] = device_ms(torch, run, None)
            rec["library_device_ms"] = device_ms(torch, run_library, None)
    if backward:  # the backward has no kernel (nor has the reference's): the exact composition, timed alone
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        out = gn.group_norm_silu(*leaves, groups, eps)
        rec["backward_composition_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(out, leaves, y, retain_graph=True), max_iters=20)
    emit(rec)
    if not ok:
        raise AssertionError(f"group_norm_silu disagrees with its plain version: {rec}")
    return rec


def graphed(torch, fn, inputs):
    """``fn(*inputs)`` captured in a CUDA graph (after one eager warm-up call): (graph, static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    return graph, out


def check_captured(torch):
    """B1 (bf16, and fp32 with its 3xTF32 prep) and B3 (bf16 and fp32) captured in a CUDA graph at main-path
    shapes, replayed on new inputs copied into the captured ones, against their plain versions there."""
    from mrisr_torch.ops import flash_attention as fa
    from mrisr_torch.ops import groupnorm as gn

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        _, b, n, m, d = FLASH_CASES[2]
        scale = 1.0 / math.sqrt(d)
        q, k, v = flash_inputs(torch, dtype, "graph", 31, [(b, n), (b, m), (b, m)], d)
        graph, (o, lse) = graphed(torch, lambda *t: fa.flash_attention_fwd(*t, scale), (q, k, v))
        for t, new in zip((q, k, v), flash_inputs(torch, dtype, "graph", 32, [(b, n), (b, m), (b, m)], d)):
            t.copy_(new)
        graph.replay()
        ro, rlse = fa.flash_attention_plain(q, k, v, scale)
        tol = FLASH_TOL[name]
        ref = ro.float()
        rms_ref = float(ref.square().mean().sqrt())
        err = (o.float() - ref).abs()
        ok = (bool((err <= tol["o_atol_rms"] * rms_ref + tol["o_rtol"] * ref.abs()).all())
              and float(err.square().mean().sqrt()) / rms_ref <= tol["o_rms_rel"]
              and bool(((lse - rlse).abs() <= tol["lse_atol"]).all()))
        emit({"phase": "kernel", "kernel": "flash_attention_fwd", "case": "cuda_graph_replay", "dtype": name,
              "shape": [b, n, m, d], "max_abs_err": float(err.max()), "tolerance": tol, "ok": ok})
        shape, groups = GN_CASES[0][1], GN_CASES[0][2]
        gen = torch.Generator(device="cuda").manual_seed(33)
        x, w, bias = ((torch.randn(s_, generator=gen, device="cuda") + 0.5).to(dtype) for s_ in (shape, shape[1:2],
                                                                                                  shape[1:2]))
        graph, y = graphed(torch, lambda *t: gn.group_norm_silu(*t, groups, 1e-5), (x, w, bias))
        x.copy_(torch.randn(shape, generator=gen, device="cuda") * 2.0)
        graph.replay()
        ref = gn.group_norm_silu_plain(x, w, bias, groups, 1e-5).float()
        err = (y.float() - ref).abs()
        ok_gn = bool((err <= GN_TOL[name]["atol"] + GN_TOL[name]["rtol"] * ref.abs()).all())
        emit({"phase": "kernel", "kernel": "group_norm_silu", "case": "cuda_graph_replay", "dtype": name,
              "shape": list(shape), "groups": groups, "max_abs_err": float(err.max()), "tolerance": GN_TOL[name],
              "ok": ok_gn})
        if not (ok and ok_gn):
            raise AssertionError(f"a kernel replayed from a CUDA graph disagrees with its plain version ({name})")


def resdiff_head_calls(torch):
    """{(shape, groups): B3 launches in one 50-step bs-8 256^2 serving chain}, recorded from one UNet forward."""
    from mrisr_torch.models.resdiff_unet import ResDiffUNet

    torch.manual_seed(0)
    unet = ResDiffUNet(image_size=SIZE, device="cuda").to(torch.bfloat16)
    x = torch.zeros((BATCH, 2, SIZE, SIZE), device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        _, heads = recording_heads(lambda: unet(x, torch.full((BATCH,), 0.5, device="cuda")))
    calls = collections.Counter()
    for (shape, groups, _, _), n in heads.items():
        calls[tuple(shape), groups] += n * STEPS
    return calls


def phase_kernels(torch):
    import torch.nn.functional as F

    recs = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": [],
            "group_norm_silu": []}
    head_calls = resdiff_head_calls(torch)
    for dtype in (torch.bfloat16, torch.float32):
        for cases, timed in ((FLASH_CASES, True), (FLASH_RAGGED, False), (FLASH_EXTREME, False),
                             (FLASH_PAD, False)):
            for case in cases:
                recs["flash_attention_fwd"].append(check_flash(torch, F, dtype, *case, timed=timed))
                for name, rec in check_flash_bwd(torch, F, dtype, *case, timed=timed).items():
                    recs[name].append(rec)
        for case in FLASH_RESIDENT:
            recs["flash_attention_fwd"].append(check_flash(torch, F, dtype, *case, timed=False))
        chain = dict.fromkeys(("ms", "bound_ms", "plain_ms", "library_ms"), 0.0)
        for i, case in enumerate(GN_CASES):
            rec = check_gn(torch, F, dtype, *case, timed=True, backward=i < 2)
            recs["group_norm_silu"].append(rec)
            for k in chain:
                chain[k] += head_calls[tuple(case[1]), case[2]] * rec[k]
        # Each of the 13 heads' time times its launches in a 50-step chain, summed: B3's share of a chain.
        calls = sum(head_calls[tuple(c[1]), c[2]] for c in GN_CASES)
        emit({"phase": "kernel_gn_totals", "dtype": str(dtype).split(".")[-1], "heads": len(GN_CASES),
              "calls_a_chain": calls, **{f"{k}_a_chain": v for k, v in chain.items()}})
        if calls != chain_expect(STEPS)["group_norm_silu"] or len(head_calls) != len(GN_CASES):
            raise AssertionError(f"the chain's B3 heads {dict(head_calls)} are not GN_CASES' 13 ({calls} launches)")
        for case in GN_RAGGED:
            recs["group_norm_silu"].append(check_gn(torch, F, dtype, *case, timed=False))
    # The backward on the SD route (the latent training step at 1024^2), fp32 as the step runs it: the fused
    # down-tower sites and the up-tower ones.
    for case in (FLASH_SD_BWD, FLASH_SD_BWD_UP):
        for name, rec in check_flash_bwd(torch, F, torch.float32, *case, timed=True).items():
            recs[name].append(rec)
    # The forward at the backward's shape: a fused 1024^2 ControlNet training step's up-tower sites.
    recs["flash_attention_fwd"].append(check_flash(torch, F, torch.float32, *FLASH_SD_STEP, timed=True))
    check_flash_autograd(torch)
    check_captured(torch)
    return recs


def profile_chain(torch, run, chain_ms=None, top=12, ranges=()):
    """``run()`` traced by ``torch.profiler``: (its result, the device time by kernel).

    A first profiler step only starts the tracer and runs one small op; the
    run is the second step, the only one kept (a window opened with the run
    itself lost more of its first events).  The device's busy time is the sum of the times of
    the events that ran on the device (kernels, copies; one stream, so they
    do not overlap).  Its idle share is taken against ``chain_ms``, the same
    run timed without the profiler, and against the profiled run's own wall
    time.  ``kernel_events`` counts the device events whose name holds each
    kernel's part (``KERNEL_PARTS``) and ``kernel_ms`` sums their device ms;
    ``flash_kernels`` gives each flash
    kernel's device ms and count by its name and head width
    (``flash_fwd_f32_kernel<40>``).  The tracer's own records are read
    (``kineto_results.events()``), not ``key_averages()``: its Python event
    tree takes more than ten times as long to build.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.update(events=p.profiler.kineto_results.events())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # The step's own range ("ProfilerStep#1") spans the whole run on the device: it is no device event.
    # Named ranges (record_function): the device time from the first to the last kernel launched inside
    # each, any gap between them included.
    by_name, in_ranges, graph_launches = {}, {}, 0
    for e in kept["events"]:
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA and not name.startswith("ProfilerStep"):
            row = (in_ranges if name in ranges else by_name).setdefault(name, [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
        elif e.device_type() == DeviceType.CPU and name.startswith("cudaGraphLaunch"):
            graph_launches += 1
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return out, {"device_busy_ms": busy_ms,
                 "ranges": {k: {"device_span_ms": ms, "count": n} for k, (ms, n) in in_ranges.items()},
                 "idle_share": None if chain_ms is None else 1.0 - busy_ms / chain_ms,
                 "profiled_chain_ms": profiled_ms, "profiled_idle_share": 1.0 - busy_ms / profiled_ms,
                 "device_events": sum(r[2] for r in rows), "graph_launches": graph_launches,
                 "kernel_events": {name: sum(n for k, _, n in rows if part in k) for name, part in KERNEL_PARTS.items()},
                 "kernel_ms": {name: sum(ms for k, ms, _ in rows if part in k) for name, part in KERNEL_PARTS.items()},
                 "flash_kernels": flash_kernels(rows),
                 "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:top]]}


def flash_kernels(rows):
    """``{"flash_fwd_f32_kernel<40>": {"ms": ..., "count": ...}, ...}`` from a trace's ``(name, ms, count)``
    rows (demangled names: ``void (anonymous namespace)::flash_fwd_f32_kernel<40>(...)``)."""
    import re

    out = {}
    for k, ms, n in rows:
        m = re.search(r"(flash_(?:fwd|bwd)_\w*?kernel<\d+>)", k)
        if m:
            row = out.setdefault(m.group(1), {"ms": 0.0, "count": 0})
            row["ms"] += ms
            row["count"] += n
    return out


# The parts of the kernels' names in a trace, by launch counter.
KERNEL_PARTS = {"flash_attention_fwd": "flash_fwd_", "flash_attention_bwd_dq": "flash_bwd_dq_",
                "flash_attention_bwd_dkv": "flash_bwd_dkv_", "group_norm_silu": "gn_silu_kernel"}


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem", ctypes.c_uint), ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_nodes(graph):
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (kept with ``keep_graph``) by launch counter:
    its ``cudaGraph_t`` walked through the driver API, each node named by its function."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, call):
        if rc != 0:
            raise RuntimeError(f"{call} failed: CUresult {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts = dict.fromkeys(KERNEL_PARTS, 0)
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), "cuKernelGetName")
        for counter, part in KERNEL_PARTS.items():
            counts[counter] += part in name.value.decode()
    return counts


# A replay's kernel records that the tracer may miss (one graphed chain's trace lacked 5 of its 1450 B3
# records, another 2 of 1450 and 1 of 100 B1 with the tracer warmed up); eager traces have held them all.
TRACE_MISS = 0.01
# Traces taken of one run at most.  Now and then the tracer drops a whole block of records: one traced
# serial volume (5 replays, 108455 device events) held 5690 events fewer, 381 of its 7250 B3 and 26 of its
# 500 B1 records, where a trace of the same volume on the same card held every one.  A trace that falls
# short by more than TRACE_MISS is taken again, and each trace's shortfall is reported.  A kernel that does
# not run falls short in every trace, and more records than launches fail at once.
TRACE_TRIES = 3


def traced(torch, run, chain_ms, expected):
    """``profile_chain`` of ``run()``, taken again (``TRACE_TRIES`` traces at most) while the trace holds fewer
    of some kernel's records than ``expected(prof)`` gives, less ``TRACE_MISS`` of them.  -> (result, profile);
    the profile's ``trace_shortfall`` lists each trace's missing records by kernel."""
    shortfall = []
    for _ in range(TRACE_TRIES):
        out, prof = profile_chain(torch, run, chain_ms)
        want = expected(prof)
        seen = prof["kernel_events"]
        shortfall.append({k: n - seen[k] for k, n in want.items()})
        if any(seen[k] > n for k, n in want.items()) or all(seen[k] >= n * (1 - TRACE_MISS) for k, n in want.items()):
            break
    prof["trace_shortfall"] = shortfall
    return out, prof


def replayed(torch, run, pipe, chains, what, chain_ms=None, expect=None):
    """A graphed main path: ``run()`` replays ``pipe``'s one captured chain ``chains`` times.  It is traced
    (``profile_chain``) with the wrappers' counts set to 0 just before it and read just after; a replay
    calls no wrapper, so they must stay 0.  Its launches are the graph's kernel nodes (which must be one
    chain's, ``expect``; by default ``chain_expect``) times the graph launches in the trace (which must be
    ``chains``); the kernels the trace shows must be those launches, less at most ``TRACE_MISS`` of them
    (``traced``).  -> (result, launches, profile)."""
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    def graph_launches(prof):
        if len(pipe.graphs) != 1:
            raise AssertionError(f"{what}: {len(pipe.graphs)} captured chains, expected 1")
        nodes = graph_kernel_nodes(next(iter(pipe.graphs.values())).graph)
        return {k: n * prof["graph_launches"] for k, n in nodes.items()}

    torch.cuda.synchronize()
    reset_launch_counts()
    out, prof = traced(torch, run, chain_ms, graph_launches)
    wrapped = launch_counts()
    nodes = graph_kernel_nodes(next(iter(pipe.graphs.values())).graph)
    launches = graph_launches(prof)
    seen = prof["kernel_events"]
    prof.update(graph_kernel_nodes=nodes, trace_missed={k: launches[k] - seen[k] for k in launches})
    if (nodes != (expect or chain_expect(STEPS)) or prof["graph_launches"] != chains or any(wrapped.values())
            or not prof["device_events"]
            or any(not launches[k] * (1 - TRACE_MISS) <= seen[k] <= launches[k] for k in launches)):
        raise AssertionError(f"{what}: graph kernel nodes {nodes}, {prof['graph_launches']} graph launches "
                             f"(expected {chains}), kernels in the trace {seen} ({prof['device_events']} device "
                             f"events), wrapper counts {wrapped}, each trace's shortfall {prof['trace_shortfall']}")
    return out, launches, prof


def timed_chains(torch, run, reps):
    """Wall ms (host clock around the call and a synchronize) and CUDA-event ms of ``reps`` calls."""
    walls, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        run()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return walls, events


def counted(torch, run):
    """``run()`` with the launch counts set to 0 just before it and read just after: (result, counts)."""
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, launch_counts()


def add_counts(totals, counts):
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n


def chain_expect(steps, n_chains=1):
    """Launches of ``n_chains`` 256^2 serving chains of ``steps`` steps: two CA sites with >= 4096 tokens
    (the 128^2 and 64^2 skips), 29 ConvBlock heads (two per ResnetBlock, 14 ResnetBlocks, final_conv); no
    backward kernel."""
    return {"flash_attention_fwd": 2 * steps * n_chains, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "group_norm_silu": 29 * steps * n_chains}


def serving_pipeline(torch, kv_pool, dtype=None, cuda_graph=True, conv_int8=False):
    """The serving configuration (``bench.py``'s): SimpleCNN, ResDiffUNet at 256^2, random weights from fixed
    seeds, cast to ``dtype`` (bf16 by default); ``conv_int8``: the int8 profile."""
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    dtype = dtype or torch.bfloat16
    torch.manual_seed(0)  # the same random weights in every profile
    cnn = SimpleCNN(device="cuda").to(dtype)
    unet = ResDiffUNet(image_size=SIZE, ca_kv_pool=kv_pool, conv_int8=conv_int8, device="cuda").to(dtype)
    return ResDiffPipeline(cnn, unet, resdiff_schedule(1000), device="cuda", cuda_graph=cuda_graph)


CHAIN_REPS = 3  # timed calls of each chain, graph and eager


def phase_chain(torch):
    """The bf16 serving chain as a captured CUDA graph and eagerly, in both profiles."""
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline

    expect = chain_expect(STEPS)
    totals = {}
    outs = {}
    for profile, kv_pool in (("fast", 8), ("exact", 0)):
        pipe = serving_pipeline(torch, kv_pool)
        eager = ResDiffPipeline(pipe.cnn, pipe.unet, pipe.sched, device="cuda", cuda_graph=False)
        gen = torch.Generator(device="cuda").manual_seed(1)
        lr = (torch.rand((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
        x_T = torch.randn((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda").to(torch.bfloat16)

        # First call: one eager warm-up chain, the capture (the wrappers count the launches they record),
        # one replay (no wrapper runs).
        t0 = time.perf_counter()
        out, first_counts = counted(torch, lambda: pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS))
        first_ms = (time.perf_counter() - t0) * 1e3
        if first_counts != {k: 2 * n for k, n in expect.items()} or len(pipe.graphs) != 1:
            raise AssertionError(f"{profile}: first call's launch counts {first_counts}, expected twice {expect}")
        if tuple(out.shape) != (BATCH, SIZE, SIZE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{profile}: bad output {tuple(out.shape)}")
        eager_out, eager_counts = counted(torch, lambda: eager.super_resolve(lr, x_T=x_T, num_steps=STEPS))
        if eager_counts != expect:
            raise AssertionError(f"{profile}: eager launch counts {eager_counts}, expected {expect}")
        # Graph and eager from the same generator (x_T drawn from it outside the graph).
        from_gen = [p.super_resolve(lr, torch.Generator(device="cuda").manual_seed(5), num_steps=STEPS)
                    for p in (pipe, eager)]
        graph_ms, graph_event_ms = timed_chains(torch, lambda: pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS),
                                                CHAIN_REPS)
        eager_ms, eager_event_ms = timed_chains(torch, lambda: eager.super_resolve(lr, x_T=x_T, num_steps=STEPS),
                                                CHAIN_REPS)
        # The main path: one replay, traced (``replayed``).
        again, counts, graph_prof = replayed(torch, lambda: pipe.super_resolve(lr, x_T=x_T, num_steps=STEPS),
                                             pipe, 1, f"{profile} graph replay", min(graph_ms))
        add_counts(totals, counts)
        # The eager chain traced the same way: the trace holds what the wrappers counted (as for a replay, the
        # tracer may miss up to TRACE_MISS of the records).
        _, eager_prof = traced(torch, lambda: eager.super_resolve(lr, x_T=x_T, num_steps=STEPS), min(eager_ms),
                               lambda _: eager_counts)
        outs[profile] = out.float()
        diff_gen = float((from_gen[0].float() - from_gen[1].float()).abs().max())
        rec = {"phase": "chain", "profile": profile, "ca_kv_pool": kv_pool, "batch": BATCH, "size": SIZE,
               "steps": STEPS, "dtype": "bfloat16", "launches": counts,
               "launches_from": "the graph's kernel nodes times the graph launches in a trace of one replay",
               "eager_launches": eager_counts, "eager_trace_launches": eager_prof["kernel_events"],
               "first_call_launches": first_counts, "first_call_ms": first_ms,
               "graph_chain_ms": graph_ms, "graph_event_ms": graph_event_ms, "eager_chain_ms": eager_ms,
               "eager_event_ms": eager_event_ms, "chain_ms": min(graph_ms),
               "slices_per_s": BATCH / (min(graph_ms) / 1e3), "eager_slices_per_s": BATCH / (min(eager_ms) / 1e3),
               "repeat_max_abs_diff": float((again.float() - out.float()).abs().max()),
               "graph_vs_eager_max_abs_diff": float((again.float() - eager_out.float()).abs().max()),
               "graph_vs_eager_same_generator_max_abs_diff": diff_gen,
               "out_abs_max": float(out.float().abs().max())}
        emit(rec)
        for mode, prof in (("graph", graph_prof), ("eager", eager_prof)):
            emit({"phase": "profile", "profile": profile, "mode": mode,
                  "chain_ms": min(graph_ms if mode == "graph" else eager_ms), **prof})
        # A graphed chain replays the kernels the eager one launches, in the same order on the same inputs:
        # the two agree to the last bit.
        if (rec["graph_vs_eager_max_abs_diff"] != 0.0 or diff_gen != 0.0 or rec["repeat_max_abs_diff"] != 0.0
                or any(not n * (1 - TRACE_MISS) <= eager_prof["kernel_events"][k] <= n
                       for k, n in eager_counts.items())):
            raise AssertionError(f"{profile}: the graphed chain disagrees with the eager chain: {rec}")
    emit({"phase": "chain", "fast_vs_exact_max_abs_diff": float((outs["fast"] - outs["exact"]).abs().max())})
    return totals


CKPT = "ckpt_256_r3.msgpack"
CKPT_REF = "PARITY_TORCH_CKPT_ref.npz"  # tools/torch_ckpt_chain.py: the JAX package's run on the CPU
CKPT_UNET = dict(image_size=SIZE, inner_channel=32, norm_groups=8)  # the checkpoint's configuration
CKPT_BAR_DB = 0.01  # per image, against the JAX chain's PSNR


def psnr_ssim(torch, final, hr):
    """Per-image PSNR and SSIM (the port's metrics, fp32 on the CPU) of ``[B, H, W, 1]`` images clipped to
    [0, 1], as ``tools/torch_ckpt_chain.py`` scores them."""
    from mrisr_torch.eval.metrics import compute_mri_metrics_per_image

    nchw = lambda a: torch.as_tensor(a).float().cpu().clamp(0, 1).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    p, s, _, _ = compute_mri_metrics_per_image(nchw(final), nchw(hr))
    return [float(v) for v in p], [float(v) for v in s]


def checkpoint_pipeline(torch, tree, kv_pool, dtype, conv_int8=False):
    """The trained checkpoint's EMA UNet behind an identity stage 1 (SimpleCNN with zero weights: its
    residual path), so the chain's condition is the stored one; ``conv_int8``: the int8 profile."""
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline
    from mrisr_torch.weights import load_flax_params

    unet = ResDiffUNet(**CKPT_UNET, ca_kv_pool=kv_pool, conv_int8=conv_int8, device="cuda")
    load_flax_params(unet, tree["ema"])
    cnn = SimpleCNN(device="cuda")
    with torch.no_grad():
        for p in cnn.parameters():
            p.zero_()
    return ResDiffPipeline(cnn.to(dtype), unet.to(dtype), resdiff_schedule(1000), device="cuda")


def phase_checkpoint(torch):
    """The trained checkpoint on the card against the JAX package's stored run: the fp32 eps forward and the
    fp32 50-step chains in both profiles, then the bf16 serving chains (for information)."""
    import numpy as np

    from mrisr_torch.utils.flax_msgpack import read_msgpack

    t0 = time.perf_counter()
    tree = read_msgpack(CKPT)
    read_s = time.perf_counter() - t0
    ref = np.load(CKPT_REF)
    cond, x_T, hr = (torch.from_numpy(ref[k]).cuda() for k in ("cond", "x_T", "hr"))
    b = cond.shape[0]
    totals = {}

    exact = checkpoint_pipeline(torch, tree, 0, torch.float32)
    x = torch.cat([cond, x_T], dim=-1).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        eps = exact.unet(x, torch.from_numpy(ref["eps_gamma"]).cuda()).permute(0, 2, 3, 1).cpu()
    want = torch.from_numpy(ref["eps"])
    err = (eps - want).abs()
    ok = bool((err <= FORWARD_TOL["atol"] + FORWARD_TOL["rtol"] * want.abs()).all())
    emit({"phase": "checkpoint", "case": "eps_forward", "dtype": "float32", "tf32": False, "shape": list(x.shape),
          "checkpoint_step": tree["step"], "read_s": read_s, "max_abs_err": float(err.max()),
          "tolerance": FORWARD_TOL, "ok": ok})
    if not ok:
        raise AssertionError(f"the checkpoint's fp32 eps on the card disagrees with JAX's: {float(err.max())}")

    fp32_psnr = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for profile, kv_pool in (("exact", 0), ("fast", 8)):
            pipe = exact if (dtype, kv_pool) == (torch.float32, 0) else checkpoint_pipeline(torch, tree, kv_pool, dtype)
            run = lambda: pipe.super_resolve(cond.to(dtype), x_T=x_T.to(dtype), num_steps=STEPS)  # noqa: E731
            run()  # warm-up and capture
            out, counts, _ = replayed(torch, run, pipe, 1, f"checkpoint {name} {profile}")
            add_counts(totals, counts)
            psnr_jax, _ = psnr_ssim(torch, ref[f"final_{profile}"], ref["hr"])
            psnr, ssim = psnr_ssim(torch, out, hr)
            delta = [abs(a - b_) for a, b_ in zip(psnr, psnr_jax)]
            rec = {"phase": "checkpoint", "case": "chain", "dtype": name, "profile": profile, "ca_kv_pool": kv_pool,
                   "images": b, "steps": STEPS, "cuda_graph": pipe.cuda_graph, "launches": counts,
                   "psnr": psnr, "ssim": ssim, "psnr_jax_fp32_cpu": psnr_jax, "abs_delta_db": delta,
                   "final_max_abs_diff_vs_jax": float((out.float().cpu() - torch.from_numpy(ref[f"final_{profile}"]))
                                                      .abs().max())}
            if dtype == torch.float32:
                fp32_psnr[profile] = psnr
                rec.update(bar_db=CKPT_BAR_DB, ok=max(delta) <= CKPT_BAR_DB)
            else:
                psnr_jax_bf16, _ = psnr_ssim(torch, ref[f"final_{profile}_bf16"], ref["hr"])
                rec["note"] = "bf16 serving chain: no bar, for information"
                rec["delta_vs_fp32_card_db"] = [a - b_ for a, b_ in zip(psnr, fp32_psnr[profile])]
                rec["psnr_jax_bf16_cpu"] = psnr_jax_bf16
                rec["abs_delta_vs_jax_bf16_db"] = [abs(a - b_) for a, b_ in zip(psnr, psnr_jax_bf16)]
            emit(rec)
            if rec.get("ok") is False:
                raise AssertionError(f"the checkpoint's fp32 {profile} chain misses {CKPT_BAR_DB} dB: {rec}")
    return totals


VOLUME_SHAPE, VOLUME_GROUP = (220, 220, 40), 2


def phase_volume(torch):
    """A synthetic 220x220x40 NIfTI through ``super_resolve_volume`` at 256^2, bs 8, bf16, 50 steps (fast
    profile), grouped (G = 2, graphed) against serial dispatch."""
    import tempfile

    import numpy as np

    from mrisr_torch.data.nifti import write_nifti
    from mrisr_torch.pipelines.volume import super_resolve_volume

    pipe = serving_pipeline(torch, 8)
    rng = np.random.default_rng(3)
    xx, yy = np.meshgrid(np.linspace(-1, 1, VOLUME_SHAPE[0]), np.linspace(-1, 1, VOLUME_SHAPE[1]), indexing="ij")
    head = (xx**2 + yy**2 < 0.8)[..., None] * np.linspace(300, 900, VOLUME_SHAPE[2])[None, None, :]
    vol = (head + rng.normal(0, 40, VOLUME_SHAPE)).astype(np.float32)
    kw = dict(resolution=SIZE, batch_size=BATCH, num_steps=STEPS, seed=7)
    n_batches = -(-VOLUME_SHAPE[2] // BATCH)  # one chain per batch, grouped or serial
    runs = {"grouped": [], "serial": []}
    launches, profs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/synthetic.nii.gz"
        write_nifti(src, vol, np.diag([1.0, 1.0, 3.0, 1.0]))
        super_resolve_volume(pipe, src, chain_group=VOLUME_GROUP, **kw)  # warm-up and capture
        # NIfTI in, NIfTI out, in turns.  The timed volumes are written uncompressed (zlib on one host core
        # would take most of a volume's time); the gzipped write is timed once, after.
        for mode in ("grouped", "serial", "serial", "grouped"):
            group = VOLUME_GROUP if mode == "grouped" else 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = super_resolve_volume(pipe, src, f"{tmp}/{mode}.nii", chain_group=group, **kw)
            runs[mode].append((time.perf_counter() - t0, img))
        # The main path: one volume of each mode, traced; its launches are the kernels in the trace.
        for mode, group in (("grouped", VOLUME_GROUP), ("serial", 1)):
            img, launches[mode], profs[mode] = replayed(
                torch, lambda: super_resolve_volume(pipe, src, chain_group=group, **kw), pipe, n_batches,
                f"volume {mode}")
            runs[mode].append((None, img))
        t0 = time.perf_counter()
        write_nifti(f"{tmp}/again.nii.gz", img.data, img.affine)
        write_s = time.perf_counter() - t0
    grouped, serial = runs["grouped"][0][1], runs["serial"][0][1]
    same = all(np.array_equal(r[1].data, serial.data) for rs in runs.values() for r in rs)
    ok = same and grouped.data.shape == VOLUME_SHAPE and bool(np.isfinite(grouped.data).all())
    timed = {mode: [r[0] for r in rs if r[0] is not None] for mode, rs in runs.items()}
    emit({"phase": "volume", "shape": list(VOLUME_SHAPE), "resolution": SIZE, "batch": BATCH, "steps": STEPS,
          "dtype": "bfloat16", "ca_kv_pool": 8, "chain_group": VOLUME_GROUP, "launches": launches["grouped"],
          "serial_launches": launches["serial"],
          "launches_from": "the graph's kernel nodes times the graph launches in a trace of one volume each",
          "trace_missed": {mode: p["trace_missed"] for mode, p in profs.items()},
          "trace_shortfall": {mode: p["trace_shortfall"] for mode, p in profs.items()},
          "grouped_s_per_volume": timed["grouped"], "serial_s_per_volume": timed["serial"],
          "grouped_slices_per_s": [VOLUME_SHAPE[2] / t for t in timed["grouped"]],
          "serial_slices_per_s": [VOLUME_SHAPE[2] / t for t in timed["serial"]], "written": "uncompressed .nii",
          "device_busy_ms": {mode: p["device_busy_ms"] for mode, p in profs.items()},
          "profiled_volume_ms": {mode: p["profiled_chain_ms"] for mode, p in profs.items()},
          "gzip_write_s": write_s, "grouped_equals_serial": same,
          "out_range": [float(grouped.data.min()), float(grouped.data.max())], "ok": ok})
    if not ok:
        raise AssertionError("volume: grouped dispatch disagrees with serial dispatch")
    counts = {}
    for c in launches.values():
        add_counts(counts, c)
    return counts


DDPM_T = 1000


def phase_ddpm(torch):
    """One full-length ancestral chain (1000 steps, eager: its noise comes from the generator each step) at
    bs 8, bf16, fast profile."""
    pipe = serving_pipeline(torch, 8)
    gen = torch.Generator(device="cuda").manual_seed(2)
    lr = (torch.rand((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    t0 = time.perf_counter()
    out, counts = counted(torch, lambda: pipe.super_resolve(lr, gen, num_steps=None))
    ms = (time.perf_counter() - t0) * 1e3
    ok = (bool(torch.isfinite(out).all()) and tuple(out.shape) == (BATCH, SIZE, SIZE, 1)
          and counts == chain_expect(DDPM_T) and not pipe.graphs)
    emit({"phase": "ddpm", "steps": DDPM_T, "batch": BATCH, "size": SIZE, "dtype": "bfloat16", "ca_kv_pool": 8,
          "cuda_graph": False, "launches": counts, "chain_ms": ms, "ms_per_step": ms / DDPM_T,
          "out_abs_max": float(out.float().abs().max()), "ok": ok})
    if not ok:
        raise AssertionError(f"ddpm: a non-finite output or launch counts {counts}")
    return counts


# Three timed calls a ResDiff profile (the bench's default is 6): the run's time limit, not the numbers, sets it.
BENCH_RUNS = (["--fast", "8", "--repeats", "3"], ["--fast", "0", "--repeats", "3"],
              ["--pipeline", "latent", "--repeats", "1"])


def release_memory(torch, after):
    """Collect Python garbage (graphs, modules and states held in reference cycles) and release the caching
    allocator's unused blocks (``empty_cache``); emit what this process still holds."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": "memory", "after": after, "allocated_gib": torch.cuda.memory_allocated() / 2**30,
          "reserved_gib": torch.cuda.memory_reserved() / 2**30})


def phase_bench(torch):
    """``python3 -m mrisr_torch.bench`` in a subprocess per profile (and the latent chain); its JSON line
    echoed.  The subprocesses share the card with this process, which first gives back the memory it
    caches."""
    release_memory(torch, "the phases before bench")
    for extra in BENCH_RUNS:
        proc = subprocess.run([sys.executable, "-m", "mrisr_torch.bench", *extra], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"mrisr_torch.bench {extra} failed: {proc.stderr[-3000:]}")
        emit({"phase": "bench", "args": extra, **json.loads(proc.stdout.strip().splitlines()[-1])})


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


TRAIN_STEPS = 3  # graphed and eager steps of each policy, from one state and the same generators
TRAIN_POLICIES = (("float32", False), ("bfloat16", False), ("bfloat16", True))


def train_expect(remat):
    """Launches of one 256^2 training step (the forward runs twice with remat)."""
    return dict(TRAIN_LAUNCHES, **({"flash_attention_fwd": 4, "group_norm_silu": 58} if remat else {}))


class _OneGraph:
    """``replayed``'s view of a graphed training step: its one captured graph."""

    def __init__(self, step):
        self.graphs = {"step": step}


def _state_tensors(state):
    flat = []

    def walk(tree):
        if hasattr(tree, "dtype"):
            flat.append(tree)
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)

    walk({"params": state.params, "opt": state.opt_state, "ema": state.ema_params})
    return flat


def phase_train(torch):
    """Full-width training steps (256^2, bs 8, dropout 0.2, Adam 1e-5, EMA 0.999) through
    ``make_resdiff_train_step`` in fp32, bf16 and bf16 with remat: the graphed step (one CUDA graph replayed
    a step) against the eager step over ``TRAIN_STEPS`` steps from one state and the same generators (losses,
    parameters, EMA, optimizer state and the generators' states bitwise equal under deterministic cuDNN);
    parameter movement, the EMA identity and fp32 masters each step; the graph's kernel nodes held to
    ``train_expect``; one traced replay (the path's launches: nodes times traced graph launches) and one
    traced eager step of each policy (``train_profile``: wall, busy and idle share side by side); and a step
    graphed under cuDNN's default (non-deterministic) algorithms, timed (``train_timing``)."""
    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.train.precision import get_policy
    from mrisr_torch.train.state import create_train_state, make_optimizer
    from mrisr_torch.train.steps import make_resdiff_train_step, step_generator

    torch.backends.cudnn.deterministic = True
    torch.manual_seed(4)
    unet = ResDiffUNet(image_size=SIZE)  # the trainer's defaults: dropout 0.2, ca_kv_pool 0
    sched = resdiff_schedule(1000)
    batch = _synthetic_batch(torch, BATCH, SIZE, 5, "cuda")
    totals = {k: 0 for k in TRAIN_LAUNCHES}
    d = TRAIN_EMA
    for precision, remat in TRAIN_POLICIES:
        expect = train_expect(remat)
        policy = get_policy(precision)
        state = create_train_state(unet, make_optimizer(TRAIN_LR), ema_decay=TRAIN_EMA)
        eager_state = state.clone()
        graphed = make_resdiff_train_step(unet, sched, policy, remat=remat)
        eager = make_resdiff_train_step(unet, sched, policy, remat=remat, cuda_graph=False)
        recs = []
        for i in range(TRAIN_STEPS):
            before = {k: p.clone() for k, p in state.params.items()}
            ema_before = {k: e.clone() for k, e in state.ema_params.items()}
            gen, egen = step_generator(6, i, "cuda"), step_generator(6, i, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, metrics = graphed(state, batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            t0 = time.perf_counter()
            eager_state, emetrics = eager(eager_state, batch, egen)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
            loss, eager_loss = float(metrics["loss"]), float(emetrics["loss"])
            moved = max(float((state.params[k] - p).abs().max()) for k, p in before.items())
            # One Adam step moves a parameter by about lr (at most (1-b1)/sqrt(1-b2) = 3.2 lr).
            # EMA: ema' = d ema + (1 - d) p', one lerp toward p', so it moves by (1 - d) of (p' - ema).  That
            # move is below an fp32 ulp of the EMA, so it is held exactly to the lerp of the values it had.
            ulp = 2.0**-23 * max(float(p.abs().max()) for p in state.params.values())  # fp32 spacing at the largest
            keys = list(ema_before)
            ema_want = torch._foreach_lerp([ema_before[k] for k in keys], [state.params[k] for k in keys], 1.0 - d)
            ema_err = max(float((state.ema_params[k] - w).abs().max()) for k, w in zip(keys, ema_want))
            ema_moved = max(float((state.ema_params[k] - e).abs().max()) for k, e in ema_before.items())
            same = (loss == eager_loss and torch.equal(gen.get_state(), egen.get_state())
                    and all(torch.equal(a, b) for a, b in zip(_state_tensors(state), _state_tensors(eager_state))))
            dtypes = sorted({str(p.dtype) for p in state.params.values()})
            ok = (out is state and same and state.step == eager_state.step == i + 1 and math.isfinite(loss)
                  and 0.0 < moved <= 4.0 * TRAIN_LR and ema_err == 0.0
                  and 0.0 < ema_moved <= 4.0 * TRAIN_LR * (1 - d) * (i + 1) + ulp and dtypes == ["torch.float32"])
            rec = {"phase": "train", "precision": precision, "remat": remat, "step": i, "batch": BATCH,
                   "size": SIZE, "loss": loss, "eager_loss": eager_loss, "graph_equals_eager": same,
                   "graph_ms": ms, "eager_ms": eager_ms, "param_max_move": moved, "ema_max_move": ema_moved,
                   "ema_identity_max_err": ema_err, "master_dtypes": dtypes, "max_memory_allocated_gib": peak,
                   "ok": ok}
            emit(rec)
            recs.append(rec)
            if not ok:
                raise AssertionError(f"training step failed its checks: {rec}")
        # The path's launches: one more replay, traced (the wrappers count nothing in it).
        replay_ms = min(r["graph_ms"] for r in recs[1:])
        gen = step_generator(6, TRAIN_STEPS, "cuda")
        _, counts, prof = replayed(torch, lambda: graphed(state, batch, gen), _OneGraph(graphed), 1,
                                   f"train {precision} remat={remat} replay", replay_ms, expect)
        add_counts(totals, counts)
        eager_prof = profile_step(torch, eager, eager_state, batch, min(r["eager_ms"] for r in recs[1:]))
        emit({"phase": "train_profile", "precision": precision, "remat": remat, "graph": "replay",
              "step_ms": replay_ms, "graph_kernel_nodes": prof["graph_kernel_nodes"], "launches": counts,
              "launches_from": "the graph's kernel nodes times the graph launches in a trace of one replay",
              **{k: v for k, v in prof.items() if k != "graph_kernel_nodes"}})
        emit({"phase": "train_profile", "precision": precision, "remat": remat, "graph": "eager",
              "step_ms": min(r["eager_ms"] for r in recs[1:]), **eager_prof})
        # The comparisons run cuDNN's deterministic algorithms; a step graphed under its default ones, timed.
        torch.backends.cudnn.deterministic = False
        timing = make_resdiff_train_step(unet, sched, policy, remat=remat)
        timing_state = state.clone()
        default_ms = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timing(timing_state, batch, step_generator(7, i, "cuda"))
            torch.cuda.synchronize()
            default_ms.append((time.perf_counter() - t0) * 1e3)
        torch.backends.cudnn.deterministic = True
        emit({"phase": "train_timing", "precision": precision, "remat": remat, "cudnn": "default",
              "first_call_ms": default_ms[0], "graph_ms": default_ms[1:],
              "deterministic_graph_ms": [r["graph_ms"] for r in recs[1:]],
              "eager_ms": [r["eager_ms"] for r in recs[1:]]})
        del graphed, eager, state, eager_state, timing, timing_state
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return totals


def profile_step(torch, step, state, batch, step_ms):
    """One traced eager training step: device busy time, idle share and the largest kernels."""
    from mrisr_torch.train.steps import step_generator

    _, rec = profile_chain(torch, lambda: step(state, batch, step_generator(6, 99, "cuda")), step_ms,
                           ranges=("group_norm_silu_backward",))
    return rec


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
        step = make_resdiff_train_step(unet, sched, device=device, cuda_graph=False)  # eager: the draws are given
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


CLI_TRAIN_STEPS, CLI_RESUME_STEPS, CLI_CACHE_STEPS, CLI_VAL_STEPS = 30, 5, 5, 10


def _run_record(out_dir):
    """The ``run_`` record a CLI trainer logs last to ``metrics.jsonl`` (throughput and data time)."""
    from pathlib import Path

    lines = Path(out_dir, "metrics.jsonl").read_text().splitlines()
    return {k: v for k, v in json.loads(lines[-1]).items() if k.startswith("run_")}


def traced_command(torch, what, run, graph_of, per_launch, graph_launches):
    """A command that captures one CUDA graph and replays it, traced whole (``profile_chain``) with the
    wrappers' counts set to 0 just before it and read just after.  Its launches are the graph's kernel nodes
    (which must be ``per_launch``) times the graph launches in the trace (which must be ``graph_launches``).
    The wrappers count the eager launches (the warm-ups) and the capture (one per node, which runs nothing),
    so the trace's kernel records must be the graph's launches plus the wrappers' counts less the nodes, less
    at most ``TRACE_MISS`` of them; a trace that falls short by more is taken again (``TRACE_TRIES`` at
    most), which runs the command again.  -> (result, launches, record)."""
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    shortfall = []
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, prof = profile_chain(torch, run)
        wall = time.perf_counter() - t0
        wrapped = launch_counts()
        nodes = graph_kernel_nodes(graph_of(out))
        launches = {k: n * prof["graph_launches"] for k, n in nodes.items()}
        want = {k: launches[k] + wrapped[k] - nodes[k] for k in nodes}
        seen = prof["kernel_events"]
        shortfall.append({k: want[k] - seen[k] for k in want})
        if any(seen[k] > want[k] for k in want) or all(seen[k] >= want[k] * (1 - TRACE_MISS) for k in want):
            break
    rec = {"command": what, "traced_wall_s": wall, "traced_run_s": prof["profiled_chain_ms"] / 1e3,
           "graph_kernel_nodes": nodes,
           "graph_launches": prof["graph_launches"], "launches": launches, "wrapper_counts": wrapped,
           "kernel_events": seen, "trace_shortfall": shortfall, "device_busy_ms": prof["device_busy_ms"],
           "device_events": prof["device_events"],
           "launches_from": "the graph's kernel nodes times the graph launches in a trace of the whole command"}
    if (nodes != per_launch or prof["graph_launches"] != graph_launches or any(wrapped[k] < nodes[k] for k in nodes)
            or any(not want[k] * (1 - TRACE_MISS) <= seen[k] <= want[k] for k in want)):
        raise AssertionError(f"cli {what}: graph kernel nodes {nodes} (expected {per_launch}), "
                             f"{prof['graph_launches']} graph launches (expected {graph_launches}), kernels in "
                             f"the trace {seen} (expected {want}), wrapper counts {wrapped}, each trace's "
                             f"shortfall {shortfall}")
    return out, launches, rec


def phase_cli(torch):
    """The command line in this process, at full width on the card (256^2, bs 8; the phantom data):
    ``train-cnn``; ``train-resdiff`` in bf16 for ``CLI_TRAIN_STEPS`` steps with validation (the graphed
    ``ResDiffPipeline`` on the EMA weights, ``CLI_VAL_STEPS``-step chains), then ``--resume`` for
    ``CLI_RESUME_STEPS`` more, held bitwise (parameters, EMA, optimizer state) to an uninterrupted run of as
    many steps (these three under deterministic cuDNN); ``build-cache`` and ``train-resdiff --cache``;
    ``sr-volume`` on a 220x220x40 NIfTI with the checkpoint just written (fp32, 50 steps).  For each trainer:
    steps per second, the loader's time to make a batch and the loop's wait for one against the step's
    device time.  The path's launches: the ``--resume`` and ``sr-volume`` commands traced whole
    (``traced_command``)."""
    import shutil
    import tempfile

    import numpy as np

    from mrisr_torch import cli
    from mrisr_torch.data.nifti import read_nifti, write_nifti

    totals = {}
    common = ["--resolution", str(SIZE), "--batch", str(BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        def command(name, argv):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result, counts = counted(torch, lambda: cli.run(argv))
            wall = time.perf_counter() - t0
            rec = {"phase": "cli", "command": name, "argv": argv[1:], "wall_s": wall, "wrapper_counts": counts}
            return result, rec

        _, rec = command("train-cnn", ["train-cnn", *common, "--steps", "10", "--out", f"{tmp}/cnn"])
        emit({**rec, **_run_record(f"{tmp}/cnn")})
        torch.backends.cudnn.deterministic = True  # the resumed run is compared bitwise
        rd = ["train-resdiff", *common, "--precision", "bfloat16", "--cnn-checkpoint", f"{tmp}/cnn/ckpt",
              "--val-every", str(CLI_TRAIN_STEPS // 2), "--val-steps", str(CLI_VAL_STEPS)]
        res, rec = command("train-resdiff", rd + ["--out", f"{tmp}/rd", "--steps", str(CLI_TRAIN_STEPS)])
        val = [json.loads(x) for x in open(f"{tmp}/rd/metrics.jsonl") if "val_psnr" in x]
        emit({**rec, **_run_record(f"{tmp}/rd"), "cudnn": "deterministic", "validations": val,
              "val_graphs": len(res["pipeline"].graphs),
              "graph_kernel_nodes": graph_kernel_nodes(res["step"].graph)})
        del res
        torch.cuda.empty_cache()
        shutil.copytree(f"{tmp}/rd/ckpt", f"{tmp}/rd_ckpt_at_{CLI_TRAIN_STEPS}")
        total = CLI_TRAIN_STEPS + CLI_RESUME_STEPS

        def resume():  # from the checkpoint the first run left, again on each trace
            shutil.rmtree(f"{tmp}/rd/ckpt")
            shutil.copytree(f"{tmp}/rd_ckpt_at_{CLI_TRAIN_STEPS}", f"{tmp}/rd/ckpt")
            return cli.run(rd + ["--out", f"{tmp}/rd", "--steps", str(total), "--resume"])

        res, counts, trace = traced_command(torch, "train-resdiff --resume", resume, lambda r: r["step"].graph,
                                            TRAIN_LAUNCHES, CLI_RESUME_STEPS)
        add_counts(totals, counts)
        resumed = res["state"]
        emit({"phase": "cli_profile", **trace, **_run_record(f"{tmp}/rd"), "step": resumed.step})
        del res
        torch.cuda.empty_cache()
        res, rec = command("train-resdiff uninterrupted", rd + ["--out", f"{tmp}/rd_full", "--steps", str(total)])
        whole = res["state"]
        same = [torch.equal(a, b) for a, b in zip(_state_tensors(resumed), _state_tensors(whole), strict=True)]
        ok = (resumed.step == whole.step == total and all(same) and len(val) == 2
              and all(math.isfinite(v["val_psnr"]) for v in val))
        emit({**rec, **_run_record(f"{tmp}/rd_full"), "cudnn": "deterministic", "step": whole.step,
              "resumed_equals_uninterrupted": all(same), "tensors_compared": len(same),
              "tensors_differing": same.count(False), "ok": ok})
        if not ok:
            raise AssertionError(f"cli: train-resdiff --resume: step {resumed.step} of {total}, "
                                 f"{same.count(False)} of {len(same)} tensors differ from the uninterrupted "
                                 f"run's, validations {val}")
        torch.backends.cudnn.deterministic = False
        del res, resumed, whole
        torch.cuda.empty_cache()

        _, rec = command("build-cache", ["build-cache", "--resolution", str(SIZE), "--out", f"{tmp}/phantom.slc"])
        emit(rec)
        _, rec = command("train-resdiff --cache", ["train-resdiff", *common, "--precision", "bfloat16",
                                                   "--cache", f"{tmp}/phantom.slc", "--out", f"{tmp}/rdc",
                                                   "--steps", str(CLI_CACHE_STEPS)])
        emit({**rec, **_run_record(f"{tmp}/rdc")})
        torch.cuda.empty_cache()

        rng = np.random.default_rng(3)
        xx, yy = np.meshgrid(np.linspace(-1, 1, VOLUME_SHAPE[0]), np.linspace(-1, 1, VOLUME_SHAPE[1]),
                             indexing="ij")
        head = (xx**2 + yy**2 < 0.8)[..., None] * np.linspace(300, 900, VOLUME_SHAPE[2])[None, None, :]
        write_nifti(f"{tmp}/vol.nii", (head + rng.normal(0, 40, VOLUME_SHAPE)).astype(np.float32),
                    np.diag([1.0, 1.0, 3.0, 1.0]))
        argv = ["sr-volume", *common, "--checkpoint", f"{tmp}/rd/ckpt", "--input", f"{tmp}/vol.nii",
                "--output", f"{tmp}/sr.nii"]
        n_chains = -(-VOLUME_SHAPE[2] // BATCH)
        res, counts, trace = traced_command(torch, "sr-volume", lambda: cli.run(argv),
                                            lambda r: next(iter(r["pipeline"].graphs.values())).graph,
                                            chain_expect(STEPS), n_chains)
        add_counts(totals, counts)
        served = read_nifti(f"{tmp}/sr.nii").data
        ok = len(res["pipeline"].graphs) == 1 and served.shape == VOLUME_SHAPE and bool(np.isfinite(served).all())
        emit({"phase": "cli_profile", **trace, "shape": list(served.shape),
              "out_range": [float(served.min()), float(served.max())],
              "traced_slices_per_s": VOLUME_SHAPE[2] / trace["traced_wall_s"], "ok": ok})
        if not ok:
            raise AssertionError(f"cli: sr-volume gave {served.shape} from {len(res['pipeline'].graphs)} graphs")
    return totals


LATENT_STEPS = 20
# (case, batch, condition size): the bench's 512^2 chain (64^2 latents, every attention dense) and a 1024^2
# chain (128^2 latents: the level-0 self-attentions see 16384 keys and go through B1, heads of D=40).
LATENT_CHAINS = (("512", 8, 512), ("1024", 2, 1024))
# The run's time limit: no separate timed call of a latent chain.  A graphed chain's time is its traced replay's
# wall (``profiled_chain_ms``), an eager chain's that of the eager call whose launches are counted.
# What the module structure gives for a 20-step chain: B3 65 a ControlNet+UNet step with the towers one after
# the other (UNet 22 ResnetBlock2D x 2 + conv_norm_out, ControlNet 10 x 2), 45 with the towers fused (the
# default: the ControlNet's 20 encoder heads launch with the UNet's, at 2C channels and 2G groups) and in
# adapter mode, and 50 in the VAE (encoder 10 x 2 + 1, decoder 14 x 2 + 1); B1 at 128^2 latents 7 a step
# unfused (UNet 2 + 3, ControlNet 2), 5 fused (the two down-tower sites take both lanes), none at 64^2.
# (mode, size, fused) -> (B3, B1) a chain.
LATENT_STATED = {("controlnet", 512, True): (950, 0), ("controlnet", 1024, True): (950, 100),
                 ("controlnet", 512, False): (1350, 0), ("controlnet", 1024, False): (1350, 140),
                 ("adapter", 512, False): (950, 0)}
# One fp32 ControlNet+UNet evaluation, bs 1, card (TF32 off) against the CPU's plain path, at the smallest size
# above 512^2 (72^2 latents: 5184 keys, B1 at the level-0 sites, as at 1024^2).  At 1024^2 the CPU leg took
# 79.7 and 99.5 s on two H100 hosts, and the run would not keep inside its 1200 s on the slower; 10.7 s here.
LATENT_FP32_SIZE, LATENT_FP32_RMS_REL = 576, 1e-4
# B1 at the SD route as the fused 1024^2 chain at bs 2 launches it: 2 lanes x 2 images x 8 heads at 128^2
# latents, D = 40 (fp32 takes it as it is, bf16 pads it to 64), at its 40 down-tower launches; its 60
# up-tower launches (the UNet alone: 2 images x 8 heads) are ``FLASH_SD_UP``, timed in fp32, as the chain
# runs.  (Before the fused towers: 64 = 8 images x 8 heads.)
FLASH_SD = ("sd_fused", 32, 16384, 16384, 40)
FLASH_SD_UP = ("sd_up", 16, 16384, 16384, 40)
# B2a/B2b at the SD route, as the fused 1024^2 training step at bs 1 runs them: 2 lanes x 8 heads, fp32 at
# D = 40 (both kernels unpadded), at its 2 down-tower sites; ``FLASH_SD_BWD_UP`` at its 3 up-tower ones (one
# image's 8 heads).  (Before the fused towers: one image's 8 heads.)
FLASH_SD_BWD = ("sd_fused", 16, 16384, 16384, 40)
FLASH_SD_BWD_UP = ("sd_up", 8, 16384, 16384, 40)
# The forward at 8x16384^2x40: the fused 1024^2 ControlNet step's up-tower sites (timed in phase ``kernel``).
FLASH_SD_STEP = ("sd_step", 8, 16384, 16384, 40)


def latent_modules(torch, dtype, seed=10):
    """SDUNet, ControlNet and AutoencoderKL at SD1.5's widths on the card, random weights from ``seed``, cast to
    ``dtype``.  The ControlNet's zero-initialised convs get random weights too, so it carries signal as a
    trained one does."""
    from torch import nn

    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL

    torch.manual_seed(seed)
    unet = SDUNet()
    torch.manual_seed(seed + 1)
    cn = ControlNet()
    for name, m in cn.named_modules():
        if isinstance(m, nn.Conv2d) and (name.startswith("controlnet_") or name.endswith("cond_embedding.conv_out")):
            m.reset_parameters()
    torch.manual_seed(seed + 2)
    vae = AutoencoderKL()
    return unet.to(dtype), cn.to(dtype), vae.to(dtype)


def gn_heads(m):
    """B3 launches of one forward of an SD module: two a ResnetBlock2D (its ``conv_norm_out`` not counted)."""
    from mrisr_torch.models.sd_layers import ResnetBlock2D

    return 2 * sum(isinstance(x, ResnetBlock2D) for x in m.modules())


def flash_sites(m, size):
    """The Transformer2Ds of an SD module whose self-attention sees more than 4096 keys at ``size``^2 pixels
    (B1 in the forward), by name; a block's level from its name: ``down_blocks_i`` i, ``up_blocks_j``
    n-1-j, the mid block n-1."""
    from mrisr_torch.models.sd_layers import DENSE_MAX_KEYS, Transformer2D

    n = len(m.block_out_channels)
    sites = []
    for name, x in m.named_modules():
        if isinstance(x, Transformer2D):
            top = name.split(".")[0]
            level = (int(top.rsplit("_", 1)[1]) if top.startswith("down_blocks_")
                     else n - 1 - int(top.rsplit("_", 1)[1]) if top.startswith("up_blocks_") else n - 1)
            if ((size // 8) >> level) ** 2 > DENSE_MAX_KEYS:
                sites.append(name)
    return sites


def latent_expect(pipe, size, steps):
    """The launches of one chain, counted from the modules: two B3 heads a ResnetBlock2D and one a
    ``conv_norm_out`` (UNet and ControlNet every step, VAE once); one B1 a Transformer2D whose self-attention
    sees more than 4096 keys (``flash_sites``).  With fused towers the ControlNet's launch with the UNet's
    encoder: nothing of its own."""
    own_cn = pipe.controlnet is not None and not pipe.fused_towers
    towers = [pipe.unet] + ([pipe.controlnet] if own_cn else [])
    per_step = gn_heads(pipe.unet) + 1 + (gn_heads(pipe.controlnet) if own_cn else 0)
    vae = gn_heads(pipe.vae.encoder) + 1 + gn_heads(pipe.vae.decoder) + 1
    return {"flash_attention_fwd": steps * sum(len(flash_sites(m, size)) for m in towers),
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "group_norm_silu": steps * per_step + vae}


def recording_shapes(run):
    """``run()`` with the arguments of every kernel launch through a wrapper recorded
    (``ops.recording_shapes``): (result, {wrapper: {key: calls}})."""
    from mrisr_torch import ops

    with ops.recording_shapes() as seen:
        out = run()
    return out, {name: dict(c) for name, c in seen.items()}


def recording_heads(run):
    """``run()`` with every B3 launch recorded: (result, {(shape, groups, eps, dtype): calls})."""
    out, seen = recording_shapes(run)
    return out, seen["group_norm_silu"]


# The graphed ControlNet chains of phase ``latent`` (the default, fused form): (size, fused) -> their output
# and ms, which phase ``tail`` holds its unfused chains to.
LATENT_RUNS = {}


def latent_inputs(torch, pipe, batch, size):
    """A chain's fixed-seed LR ``[B, S, S, 1]`` (bf16) and draws."""
    from mrisr_torch.pipelines.latent import ChainNoise

    gen = torch.Generator(device="cuda").manual_seed(21)
    lr = (torch.rand((batch, size, size, 1), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    return lr, ChainNoise.draw(pipe.latent_shape(lr), LATENT_STEPS, gen, "cuda")


def latent_pipeline(torch, unet, side, vae, prompt, size, adapter=False, fused=None, cuda_graph=True):
    """A LatentSRPipeline on the card and its expected launches a chain, held to ``LATENT_STATED``."""
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.pipelines.latent import LatentSRPipeline

    kw = dict(adapter=side) if adapter else {}
    pipe = LatentSRPipeline(unet, None if adapter else side, vae, sd15_schedule(), prompt, fused_towers=fused,
                            device="cuda", cuda_graph=cuda_graph, **kw)
    expect = latent_expect(pipe, size, LATENT_STEPS)
    stated = LATENT_STATED.get((pipe.mode, size, pipe.fused_towers))
    if stated and (expect["group_norm_silu"], expect["flash_attention_fwd"]) != stated:
        raise AssertionError(f"latent {pipe.mode} {size}: the modules give {expect}, stated {stated}")
    return pipe, expect


def latent_chain(torch, unet, side, vae, prompt, case, batch, size, adapter=False, eager_too=True):
    """One latent chain configuration, graphed (and eagerly): launch counts, graph = eager bitwise from one
    generator, wall and CUDA-event ms, peak memory, one traced chain of each mode.  -> (launches of the traced
    replay, B3 head shapes of the eager chain, the replay's trace)."""
    pipe, expect = latent_pipeline(torch, unet, side, vae, prompt, size, adapter)
    mode = pipe.mode
    lr, noise = latent_inputs(torch, pipe, batch, size)
    run = lambda: pipe.super_resolve(lr, num_steps=LATENT_STEPS, noise=noise)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, first_counts = counted(torch, run)  # eager warm-up, capture (counted), one replay
    first_ms = (time.perf_counter() - t0) * 1e3
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    what = f"latent {mode} {size}"
    if first_counts != {k: 2 * n for k, n in expect.items()} or len(pipe.graphs) != 1:
        raise AssertionError(f"{what}: first call's launch counts {first_counts}, expected twice {expect}")
    if tuple(out.shape) != (batch, size, size, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: bad output {tuple(out.shape)}")
    again, counts, graph_prof = replayed(torch, run, pipe, 1, f"{what} graph replay", None, expect)
    graph_ms, graph_event_ms = [graph_prof["profiled_chain_ms"]], None
    if mode == "controlnet":
        LATENT_RUNS[size, pipe.fused_towers] = {"out": again, "chain_ms": graph_ms[0], "launches": counts}
    rec = {"phase": "latent", "mode": mode, "case": case, "batch": batch, "size": size, "latent": size // 8,
           "steps": LATENT_STEPS, "dtype": "bfloat16", "fused_towers": pipe.fused_towers,
           "expected_launches": expect, "launches": counts,
           "launches_from": "the graph's kernel nodes times the graph launches in a trace of one replay",
           "first_call_launches": first_counts, "first_call_ms": first_ms, "graph_chain_ms": graph_ms,
           "graph_event_ms": graph_event_ms, "chain_ms": min(graph_ms),
           "slices_per_s": batch / (min(graph_ms) / 1e3), "graph_peak_gib": graph_peak,
           "repeat_max_abs_diff": float((again.float() - out.float()).abs().max()),
           "out_abs_max": float(out.float().abs().max())}
    heads = None
    bad = rec["repeat_max_abs_diff"] != 0.0
    if eager_too:
        eager = latent_pipeline(torch, unet, side, vae, prompt, size, adapter, cuda_graph=False)[0]
        erun = lambda: eager.super_resolve(lr, num_steps=LATENT_STEPS, noise=noise)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The counted eager chain is also the timed one (the run's time limit).
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        (eager_out, heads), eager_counts = counted(torch, lambda: recording_heads(erun))
        end.record()
        torch.cuda.synchronize()
        eager_ms, eager_event_ms = [(time.perf_counter() - t0) * 1e3], [start.elapsed_time(end)]
        eager_peak = torch.cuda.max_memory_allocated() / 2**30
        gen5 = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa: E731
        # The traced eager chain is the one that draws from a generator (its launches are the counted one's).
        from_gen = [pipe.super_resolve(lr, gen5(), LATENT_STEPS)]
        eager_gen_out, eager_prof = traced(torch, lambda: eager.super_resolve(lr, gen5(), LATENT_STEPS), min(eager_ms),
                                           lambda _: eager_counts)
        from_gen.append(eager_gen_out)
        rec.update(eager_launches=eager_counts, eager_trace_launches=eager_prof["kernel_events"],
                   eager_chain_ms=eager_ms, eager_event_ms=eager_event_ms, eager_peak_gib=eager_peak,
                   eager_slices_per_s=batch / (min(eager_ms) / 1e3),
                   graph_vs_eager_max_abs_diff=float((again.float() - eager_out.float()).abs().max()),
                   graph_vs_eager_same_generator_max_abs_diff=float((from_gen[0].float() - from_gen[1].float())
                                                                    .abs().max()),
                   b3_head_shapes=len(heads))
        bad = (bad or eager_counts != expect or rec["graph_vs_eager_max_abs_diff"] != 0.0
               or rec["graph_vs_eager_same_generator_max_abs_diff"] != 0.0
               or any(not n * (1 - TRACE_MISS) <= eager_prof["kernel_events"][k] <= n for k, n in eager_counts.items()))
    emit(rec)
    emit({"phase": "latent_profile", "mode": mode, "case": case, "graph": "replay", "chain_ms": min(graph_ms),
          **graph_prof})
    if eager_too:
        emit({"phase": "latent_profile", "mode": mode, "case": case, "graph": "eager", "chain_ms": min(eager_ms),
              **eager_prof})
    if bad:
        raise AssertionError(f"{what}: graph and eager disagree, or launch counts differ from {expect}: {rec}")
    return counts, heads, graph_prof


def on_host_thread(torch, fn, no_grad=True):
    """``fn()`` on a thread beside the card's work (a CPU reference: host work): a future of (its result, its
    seconds).  Its modules and inputs are made before it starts, so it draws nothing from the global
    generators."""
    def run():
        with torch.set_grad_enabled(not no_grad):
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0

    return concurrent.futures.ThreadPoolExecutor(1).submit(run)


def start_latent_fp32(torch):
    """The fp32 ControlNet+UNet evaluation of ``check_latent_fp32``: the card's modules and inputs, and the CPU's
    plain evaluation started on a thread (``on_host_thread``)."""
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet

    unet, cn, _ = latent_modules(torch, torch.float32, seed=30)
    cpu_unet, cpu_cn = SDUNet(device="cpu"), ControlNet(device="cpu")
    cpu_unet.load_state_dict({k: v.cpu() for k, v in unet.state_dict().items()})
    cpu_cn.load_state_dict({k: v.cpu() for k, v in cn.state_dict().items()})
    lat = LATENT_FP32_SIZE // 8
    gen = torch.Generator().manual_seed(31)
    x = torch.randn((1, 4, lat, lat), generator=gen)
    cond = torch.rand((1, 3, LATENT_FP32_SIZE, LATENT_FP32_SIZE), generator=gen) * 2 - 1
    ctx = torch.randn((1, 77, 768), generator=gen)
    t = torch.tensor([500])

    def evaluate(u, c, dev):
        xs, conds, ctxs, ts = (a.to(dev) for a in (x, cond, ctx, t))
        down, mid = c(xs, ts, ctxs, cond_image=conds)
        return u(xs, ts, ctxs, down_block_additional_residuals=down, mid_block_additional_residual=mid)

    return {"unet": unet, "cn": cn, "evaluate": evaluate,
            "cpu": on_host_thread(torch, lambda: evaluate(cpu_unet, cpu_cn, "cpu"))}


def check_latent_fp32(torch, started):
    """One fp32 ControlNet+UNet evaluation at ``LATENT_FP32_SIZE``^2 (bs 1; B1 at its D=40 sites), the card's
    kernels (TF32 off) against the CPU's plain path (``start_latent_fp32``): max abs error over max |ref|, rms
    error over rms(ref)."""
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    with torch.no_grad():
        reset_launch_counts()
        got = started["evaluate"](started["unet"], started["cn"], "cuda").cpu()
        counts = launch_counts()
    ref, cpu_s = started["cpu"].result()
    lat = LATENT_FP32_SIZE // 8
    err = (got - ref).abs()
    rms_rel = float(err.square().mean().sqrt() / ref.square().mean().sqrt())
    expect = {"flash_attention_fwd": 7, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
              "group_norm_silu": 65}
    ok = rms_rel <= LATENT_FP32_RMS_REL and counts == expect and bool(torch.isfinite(got).all())
    rec = {"phase": "latent_fp32", "size": LATENT_FP32_SIZE, "latent": lat, "dtype": "float32", "tf32": False,
           "launches": counts, "max_abs_err": float(err.max()), "ref_abs_max": float(ref.abs().max()),
           "max_abs_err_over_max_ref": float(err.max() / ref.abs().max()), "rms_err_over_rms_ref": rms_rel,
           "bar_rms_rel": LATENT_FP32_RMS_REL, "cpu_eval_s": cpu_s, "cpu_eval": "on a thread beside the chains",
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"latent fp32 evaluation on the card disagrees with the CPU (launches {expect}): {rec}")


def phase_latent(torch):
    """The latent SD1.5 chains: ControlNet mode at 512^2 (bs 8) and 1024^2 (bs 2), graphed and eager; an
    adapter-mode chain at 512^2, graphed; the fp32 evaluation against the CPU; B3 at every head shape of the
    512^2 chain and B1 at the SD route, both dtypes, against their plain versions."""
    import torch.nn.functional as F

    totals = {}
    fp32 = start_latent_fp32(torch)  # its CPU leg runs beside the chains
    prompt = torch.randn((1, 77, 768), generator=torch.Generator().manual_seed(20)).to(torch.bfloat16)
    unet, cn, vae = latent_modules(torch, torch.bfloat16)
    heads = None
    for case, batch, size in LATENT_CHAINS:  # eagerly too at 512^2 only (the run's time limit)
        counts, seen, prof = latent_chain(torch, unet, cn, vae, prompt, case, batch, size, eager_too=size == 512)
        if heads is None and seen:  # by shape, whatever dtype each ran in: each is checked in both below
            heads = {}
            for (shape, groups, eps, _), calls in seen.items():
                heads[shape, groups, eps] = heads.get((shape, groups, eps), 0) + calls
            # B3 inside the graphed chain whose eager twin gave the heads: its device time in the traced replay.
            b3_graph = {"device_ms_a_chain": prof["kernel_ms"]["group_norm_silu"],
                        "launches_in_trace": prof["kernel_events"]["group_norm_silu"],
                        "launches_a_chain": counts["group_norm_silu"], "chain": f"controlnet {size}^2 bs {batch}"}
        add_counts(totals, counts)
        torch.cuda.empty_cache()
    del cn
    torch.manual_seed(11)
    from mrisr_torch.models.adapter import T2IAdapter

    adapter = T2IAdapter().to(torch.bfloat16)
    counts, _, _ = latent_chain(torch, unet, adapter, vae, prompt, "512", 8, 512, adapter=True, eager_too=False)
    add_counts(totals, counts)
    del unet, vae, adapter
    torch.cuda.empty_cache()
    check_latent_fp32(torch, fp32)
    del fp32
    torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        chain = dict.fromkeys(("ms", "bound_ms", "plain_ms", "library_ms"), 0.0)
        for (shape, groups, eps), calls in sorted(heads.items(), key=lambda kv: -math.prod(kv[0][0])):
            rec = check_gn(torch, F, dtype, "latent_head", shape, groups, timed=True, eps=eps, brief=True)
            emit({"phase": "latent_head", "shape": list(shape), "groups": groups, "eps": eps,
                  "dtype": rec["dtype"], "calls_in_512_eager_chain": calls})
            for k in chain:
                chain[k] += calls * rec[k]
        # Each head's time times its calls in a 512^2 chain, summed: B3's share of a chain in this dtype.  Beside
        # it, B3's device time in the graphed chain's traced replay (the same heads, launched from the graph).
        emit({"phase": "latent_head_totals", "dtype": str(dtype).split(".")[-1], "heads": len(heads),
              "calls_a_chain": sum(heads.values()), **{f"{k}_a_chain": v for k, v in chain.items()},
              "graph_trace": b3_graph})
        check_flash(torch, F, dtype, *FLASH_SD, timed=True)
    check_flash(torch, F, torch.float32, *FLASH_SD_UP, timed=True)
    return totals


LT_STEPS, LT_LR, LT_LORA_RANK, LT_CFG = 3, 1e-5, 4, 0.1
# (mode, condition size, batch, cached latents): the reference notebook's ControlNet+LoRA at 256^2 from
# pixels, and ControlNet mode at 1024^2 (128^2 latents: B1/B2 at the level-0 self-attentions) from cached
# latents.  What the modules give a step: B3 107 at 256^2 (UNet 22 ResnetBlock2D x 2 + conv_norm_out,
# ControlNet 10 x 2, two VAE encodes of 10 x 2 + 1), 65 from cached latents; B1 7 at 1024^2 (UNet 2 + 3,
# ControlNet 2); B2a/B2b 5 in ControlNet mode (ControlNet 2, UNet up block 3: its down blocks need no
# backward), 7 with LoRA.  With the towers fused (the default) the ControlNet's 20 heads and 2 sites launch with
# the UNet's encoder: B3 87 and 45, B1 5, and B2a/B2b 5 in both modes (the two down-tower sites at twice the
# batch, the UNet's up blocks 3).
LT_CASES = (("cn_lora", 256, 2, False), ("controlnet", 1024, 1, True))
# (mode, size, cached, fused) -> (B3, B1, B2a) a step
LT_STATED = {("cn_lora", 256, False, True): (87, 0, 0), ("controlnet", 1024, True, True): (45, 5, 5),
             ("controlnet", 256, False, True): (87, 0, 0), ("controlnet", 576, True, True): (45, 5, 5),
             ("controlnet", 1024, True, False): (65, 7, 5)}
# One ControlNet step's gradients, card (kernels, TF32 off) against the CPU's plain path, at the smallest size
# above 512^2 (72^2 latents: 5184 keys, B1/B2 at level 0; 1024^2 takes minutes on the host); per parameter
# ||g_gpu - g_cpu|| <= GRAD_TOL ||g_cpu||, the loss within 1e-4.
LT_GRAD_SIZE = 576
# ``train-latent`` at 256^2, bs 2, traced whole: ControlNet mode for a throughput reading (as phase ``cli``
# runs ``train-resdiff``), the LoRA and adapter modes for two steps each (captured and replayed).
LT_CLI_RUNS = (("controlnet", 30), ("lora", 2), ("adapter", 2))
# Replays in a traced window.  The tracer can lose the first ~20 records of a window (a whole run lost 20 of a
# 256^2 step's 6307, 4 of them B3, in each of three traces): one replay of a 107-launch graph cannot hold that
# within TRACE_MISS, ten can.
LT_TRACED_REPLAYS = 10


def latent_train_expect(unet, cn, vae, mode, size, cached, fused=True, stated=None):
    """The launches of one latent training step, counted from the modules (``gn_heads``, ``flash_sites``):
    B3 in the forward of the UNet (and its ``conv_norm_out``), the ControlNet and, from pixels, two VAE
    encodes (its backward is the plain composition); B1 at each flash site; B2a/B2b at each one the
    gradient reaches: the ControlNet's and the UNet's up blocks' in ControlNet mode, every one with LoRA.
    ``fused`` (a ControlNet mode's towers fused, the default): the ControlNet's heads and sites launch with
    the UNet's encoder, and the backward reaches every merged down-tower site and the UNet's up blocks'.
    ``stated``: (B3, B1, B2) to hold the count to, in place of ``LT_STATED``'s (towers of another depth)."""
    unet_sites = flash_sites(unet, size)
    cn_sites = [] if cn is None or fused else flash_sites(cn, size)
    up_sites = sum(n.startswith("up_blocks_") for n in unet_sites)
    if cn is not None and fused:
        bwd = len(unet_sites)
    else:
        bwd = len(cn_sites) + (len(unet_sites) if "lora" in mode else up_sites)
    b3 = (gn_heads(unet) + 1 + (0 if cn is None or fused else gn_heads(cn))
          + (0 if cached else 2 * (gn_heads(vae.encoder) + 1)))
    expect = {"flash_attention_fwd": len(unet_sites) + len(cn_sites), "flash_attention_bwd_dq": bwd,
              "flash_attention_bwd_dkv": bwd, "group_norm_silu": b3}
    stated = stated or LT_STATED.get((mode, size, cached, cn is not None and fused))
    got = (b3, expect["flash_attention_fwd"], bwd)
    if stated and got != stated:
        raise AssertionError(f"latent_train {mode} {size}: the modules give {expect}, stated {stated}")
    return expect


def latent_train_batch(torch, batch, size, seed, vae=None, device="cuda"):
    """A fixed-seed ``{"hr", "lr"}`` batch of ``[B, S, S, 1]`` slices in [0, 1]; with ``vae`` the cached-latent
    batch instead: the posterior moments of both (``[B, S/8, S/8, 4]``) and the ``lr`` pixels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hr = torch.rand((batch, size, size, 1), generator=gen, device=device)
    lr = (hr + 0.1 * torch.randn(hr.shape, generator=gen, device=device)).clamp(0, 1)
    if vae is None:
        return {"hr": hr, "lr": lr}
    out = {"lr": lr}
    with torch.no_grad():
        for side, x in (("hr", hr), ("lr", lr)):
            mean, logvar = vae.encode_moments(x.reshape(batch, 1, size, size).expand(-1, 3, -1, -1))
            out[f"{side}_mean"], out[f"{side}_logvar"] = (t.permute(0, 2, 3, 1).contiguous() for t in (mean, logvar))
    return out


def latent_train_step(torch, unet, cn, vae, mode, cached, prompt, empty, device="cuda", cuda_graph=True, fused=None):
    """(a train state, the step) of ``mode`` (``"cn_lora"`` or ``"controlnet"``), AdamW with clipping at 1.0;
    ``fused``: the towers' form (None: the default, fused)."""
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.lora import init_lora_params
    from mrisr_torch.train import latent
    from mrisr_torch.train.state import create_train_state, make_optimizer

    tx = make_optimizer(LT_LR, kind="adamw", max_grad_norm=1.0)
    kw = dict(empty_embeds=empty, proportion_empty_prompts=LT_CFG, latents_cached=cached, device=device,
              cuda_graph=cuda_graph, fused=fused)
    sched = sd15_schedule()
    if mode == "cn_lora":
        lora = init_lora_params(unet, LT_LORA_RANK, generator=torch.Generator(device=device).manual_seed(41))
        state = create_train_state(latent.cn_lora_params(cn, lora), tx, device=device)
        return state, latent.make_cn_lora_train_step(unet, cn, vae, sched, prompt, **kw)
    state = create_train_state(cn, tx, device=device)
    return state, latent.make_controlnet_train_step(unet, cn, vae, sched, prompt, **kw)


def latent_train_case(torch, unet, cn, vae, prompt, empty, mode, size, batch, cached):
    """One training configuration: the graphed step (first call: warm-ups and capture) and, at 256^2, the
    eager step over ``LT_STEPS`` steps from one state and the same generators (losses, parameters,
    optimizer and generator states bitwise equal under deterministic cuDNN); graphed ms a step and peak
    memory; ``LT_TRACED_REPLAYS`` traced replays, their launches from the graph's kernel nodes held to
    ``latent_train_expect``.  -> (launches, {(shape, groups, eps): B3 calls} of the first graphed call: its
    eager warm-ups and the capture)."""
    from mrisr_torch.train.steps import step_generator

    expect = latent_train_expect(unet, cn, vae, mode, size, cached)
    data = latent_train_batch(torch, batch, size, 42, vae if cached else None)
    state, graphed = latent_train_step(torch, unet, cn, vae, mode, cached, prompt, empty)
    eager_too = size <= 256
    if eager_too:
        eager_state, eager = state.clone(), latent_train_step(torch, unet, cn, vae, mode, cached, prompt, empty,
                                                                cuda_graph=False)[1]
    recs, what = [], f"latent_train {mode} {size}"
    for i in range(LT_STEPS):
        before = {k: p.clone() for k, p in state.params.items()}
        gen = step_generator(43, i, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 0:
            (out, metrics), heads = recording_heads(lambda: graphed(state, data, gen))
        else:
            out, metrics = graphed(state, data, gen)
        torch.cuda.synchronize()
        rec = {"phase": "latent_train", "mode": mode, "size": size, "batch": batch, "cached_latents": cached,
               "dtype": "float32", "step": i, "graph_ms": (time.perf_counter() - t0) * 1e3,
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
               "loss": float(metrics["loss"]),
               "param_max_move": max(float((state.params[k] - p).abs().max()) for k, p in before.items())}
        ok = out is state and state.step == i + 1 and math.isfinite(rec["loss"]) and 0.0 < rec["param_max_move"]
        if eager_too:
            egen = step_generator(43, i, "cuda")
            t0 = time.perf_counter()
            eager_state, emetrics = eager(eager_state, data, egen)
            torch.cuda.synchronize()
            same = (float(emetrics["loss"]) == rec["loss"] and torch.equal(gen.get_state(), egen.get_state())
                    and all(torch.equal(a, b) for a, b in zip(_state_tensors(state), _state_tensors(eager_state),
                                                              strict=True)))
            rec.update(eager_ms=(time.perf_counter() - t0) * 1e3, eager_loss=float(emetrics["loss"]),
                       graph_equals_eager=same)
            ok = ok and same
        rec["ok"] = ok
        emit(rec)
        recs.append(rec)
        if not ok:
            raise AssertionError(f"{what}: training step failed its checks: {rec}")
    step_ms = min(r["graph_ms"] for r in recs[1:])

    def replays():
        for j in range(LT_TRACED_REPLAYS):
            graphed(state, data, step_generator(43, LT_STEPS + j, "cuda"))

    _, counts, prof = replayed(torch, replays, _OneGraph(graphed), LT_TRACED_REPLAYS,
                               f"{what} {LT_TRACED_REPLAYS} replays", step_ms * LT_TRACED_REPLAYS, expect)
    emit({"phase": "latent_train_profile", "mode": mode, "size": size, "batch": batch, "cached_latents": cached,
          "step_ms": step_ms, "replays": LT_TRACED_REPLAYS, "expected_launches_a_step": expect, "launches": counts,
          "launches_from": f"the graph's kernel nodes times the graph launches in a trace of {LT_TRACED_REPLAYS} "
                           "replays", **prof})
    # The SD route's flash kernels run at SD1.5's head width: every one in the trace at D = 40, none padded.
    padded = [k for k in prof["flash_kernels"] if not k.endswith("<40>")]
    if padded:
        raise AssertionError(f"{what}: flash kernels at another head width than 40: {prof['flash_kernels']}")
    return counts, heads


def start_latent_train_grad(torch, unet, cn, prompt):
    """The inputs of ``check_latent_train_grad`` (a cached-latent batch and fixed draws at ``LT_GRAD_SIZE``^2,
    bs 1) and its CPU leg, started on a thread beside the card's work (``on_host_thread``)."""
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.train import latent
    from mrisr_torch.train.state import Optimizer, create_train_state

    size, lat = LT_GRAD_SIZE, LT_GRAD_SIZE // 8
    sched = sd15_schedule()
    cpu_unet, cpu_cn = SDUNet(device="cpu"), ControlNet(device="cpu")
    cpu_unet.load_state_dict({k: v.cpu() for k, v in unet.state_dict().items()})
    cpu_cn.load_state_dict({k: v.cpu() for k, v in cn.state_dict().items()})
    gen = torch.Generator().manual_seed(44)
    batch = {"lr": torch.rand((1, size, size, 1), generator=gen)}
    for side in ("hr", "lr"):
        batch[f"{side}_mean"] = torch.randn((1, lat, lat, 4), generator=gen)
        batch[f"{side}_logvar"] = -4.0 + 0.1 * torch.randn((1, lat, lat, 4), generator=gen)
    draws = {"hr_noise": torch.randn((1, 4, lat, lat), generator=gen),
             "lr_noise": torch.randn((1, 4, lat, lat), generator=gen), "t": torch.tensor([400]),
             "eps": torch.randn((1, 4, lat, lat), generator=gen)}

    def gradients(u, c, vae, device):
        seen = {}

        def record(grads, opt_state, params):  # an optimizer that keeps the gradients and moves nothing
            seen.update(grads)
            return {k: torch.zeros_like(g) for k, g in grads.items()}, opt_state

        state = create_train_state(c, Optimizer(lambda p: {}, record), device=device)
        step = latent.make_controlnet_train_step(u, c, vae, sched, prompt.to(device), latents_cached=True,
                                                 device=device, cuda_graph=False)
        on = lambda tree: {k: v.to(device) for k, v in tree.items()}  # noqa: E731
        _, metrics = step(state, on(batch), None, on(draws))
        return {k: g.cpu() for k, g in seen.items()}, float(metrics["loss"])

    cpu_vae = AutoencoderKL(device="cpu")  # the cached path reads only its scaling factor
    return {"gradients": gradients, "cpu": on_host_thread(
        torch, lambda: gradients(cpu_unet, cpu_cn, cpu_vae, "cpu"), no_grad=False)}


def check_latent_train_grad(torch, unet, cn, started):
    """One ControlNet step from cached latents at ``LT_GRAD_SIZE``^2, bs 1, eager with fixed draws: the
    card's kernels (TF32 off) against the CPU's plain path (``start_latent_train_grad``), gradient by
    gradient."""
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.ops import launch_counts, reset_launch_counts

    size, lat = LT_GRAD_SIZE, LT_GRAD_SIZE // 8
    expect = latent_train_expect(unet, cn, None, "controlnet", size, True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    g_gpu, loss_gpu = started["gradients"](unet, cn, AutoencoderKL(device="cuda"), "cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    counts = launch_counts()
    (g_cpu, loss_cpu), cpu_s = started["cpu"].result()
    rel = {k: float((g_gpu[k] - g).norm() / g.norm().clamp_min(1e-30)) for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    ok = rel[worst] <= GRAD_TOL and counts == expect and abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    rec = {"phase": "latent_train_grad", "mode": "controlnet", "size": size, "latent": lat, "batch": 1,
           "cached_latents": True, "dtype": "float32", "tf32": False, "launches": counts, "expected": expect,
           "loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "leaves": len(rel), "worst_leaf": worst,
           "worst_rel_l2": rel[worst], "median_rel_l2": sorted(rel.values())[len(rel) // 2], "tolerance": GRAD_TOL,
           "gpu_step_s": gpu_s, "cpu_step_s": cpu_s, "cpu_step": "on a thread beside the training cases", "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"latent training gradients on the card disagree with the CPU plain path: {rec}")


def phase_latent_train(torch):
    """The latent family's training at SD1.5's widths (fp32 weights and states, random weights from fixed
    seeds, the ControlNet's zero convs given random values, 77x768 prompt, CFG dropout 0.1, AdamW 1e-5 clipped
    at 1.0): ``LT_CASES`` through ``latent_train_case``; B3 in fp32 against its plain version at every head
    shape those steps gave it; one step's gradients against the CPU (``check_latent_train_grad``);
    ``train-latent`` in this process at 256^2, bs 2, in each mode of ``LT_CLI_RUNS``, traced whole
    (``traced_command``)."""
    import tempfile

    import torch.nn.functional as F

    from mrisr_torch import cli

    torch.backends.cudnn.deterministic = True
    unet, cn, vae = latent_modules(torch, torch.float32, seed=40)
    gen = torch.Generator().manual_seed(45)
    prompt = (0.02 * torch.randn((1, 77, 768), generator=gen)).cuda()
    empty = torch.zeros((1, 77, 768), device="cuda")
    grad_check = start_latent_train_grad(torch, unet, cn, prompt)  # its CPU leg runs beside the cases
    totals, heads = {}, {}
    for mode, size, batch, cached in LT_CASES:
        counts, seen = latent_train_case(torch, unet, cn, vae, prompt, empty, mode, size, batch, cached)
        add_counts(totals, counts)
        for key, calls in seen.items():
            heads.setdefault(key, {})[f"{mode} {size}"] = calls
        torch.cuda.empty_cache()
    for (shape, groups, eps, dtype), calls in sorted(heads.items(), key=lambda kv: -math.prod(kv[0][0])):
        rec = check_gn(torch, F, dtype, "latent_train_head", shape, groups, timed=False, eps=eps)
        emit({"phase": "latent_train_head", "shape": list(shape), "groups": groups, "eps": eps, "dtype": rec["dtype"],
              "calls_in_first_graphed_call": calls})
    check_latent_train_grad(torch, unet, cn, grad_check)
    del grad_check
    torch.backends.cudnn.deterministic = False
    expect = {mode: latent_train_expect(unet, cn if mode == "controlnet" else None, vae, mode, 256, False)
              for mode, _ in LT_CLI_RUNS}
    del unet, cn, vae
    torch.cuda.empty_cache()
    for mode, steps in LT_CLI_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["train-latent", "--mode", mode, "--resolution", "256", "--batch", "2", "--steps", str(steps),
                    "--out", tmp]
            res, counts, trace = traced_command(torch, f"train-latent {mode}", lambda argv=argv: cli.run(argv),
                                                lambda r: r["step"].graph, expect[mode], steps)
            state = res["state"]
            ok = state.step == steps and all(bool(torch.isfinite(p).all()) for p in state.params.values())
            emit({"phase": "latent_train_cli", "mode": mode, **trace, **_run_record(tmp), "step": state.step,
                  "ok": ok})
            if not ok:
                raise AssertionError(f"train-latent {mode}: step {state.step} of {steps}, or a non-finite parameter")
        add_counts(totals, counts)
        del res, state
        release_memory(torch, f"train-latent {mode}")
    return totals


# Phase ``prep``: the user's workflow around the model with no JAX, at the sizes users run it.
# (a) Weights: SD1.5-width SDUNet and AutoencoderKL (fp32, random from fixed seeds) exported to diffusers-named
# ``.safetensors`` and through ``convert-weights`` to the reference's ``.npz``; ``train-latent --weights-dir``
# from them; a LatentSRPipeline on them serving a NIfTI serially and grouped.
PREP_SEEDS = {"unet": 60, "vae": 61, "controlnet": 62, "prompt": 63}
# The UNet converted in (a): SD1.5's widths at a smaller depth (three levels of the four, the last 1280 one
# dropped; one ResnetBlock2D and Transformer2D a down block, two an up block, the full model's two and
# three).  Its ``.npz`` write, zlib on one core, took 169.0-215.4 s at full depth on the H100 host (NVIDIA
# H100 80GB HBM3, 700.00 W) and set the phase's length; 142.9-166.0 s at one block a level.
PREP_UNET_CUT = dict(block_out_channels=(320, 640, 1280), layers_per_block=1)
# ``train-latent --weights-dir`` builds its UNet at the depth of the ``unet.npz`` it reads and a ControlNet to
# match (fused): a step's launches, counted from those modules (B3, B1, B2), stated here.
PREP_TRAIN_STATED = (65, 0, 0)
# N4 in (c) stops after this many iterations (the reference's cap is 25; the pair converges in 18-20, which
# took 195.6-261.9 s a volume on that host and then set the phase's length).
PREP_N4_ITERATIONS = 10
PREP_CONTEXT = (77, 768)
PREP_TRAIN = ["--mode", "controlnet", "--resolution", "256", "--batch", "2", "--steps", "2"]
PREP_VOLUME, PREP_VOLUME_BATCH, PREP_VOLUME_GROUP = (256, 256, 8), 4, 2
# (b) Data: a BIDS tree of two subjects, the 64 mT scan on a 146x182x36 grid (1.5 x 1.5 x 5 mm, the x axis
# stored flipped) and the 3 T scan on 176x240x256 (1 mm); a DICOM tree of two patients x 16 slices.
PREP_SUBJECTS = 2
PREP_LR_GRID, PREP_LR_AFFINE = (146, 182, 36), (-1.5, 1.5, 5.0)
PREP_HR_GRID = (176, 240, 256)
PREP_DICOM = (2, 16, 256)  # patients, slices, rows = columns
# The card's ``preprocess-slices`` (subject 1's slices) and ``evaluate`` (the four means over every
# PREP_EVAL_STRIDE-th exported pair) against the same commands with ``--cpu`` on the same inputs: slices within
# PREP_SLICES_TOL (rtol, atol), means within PREP_SCORES_RTOL, the counts equal.
PREP_SLICES_TOL, PREP_SCORES_RTOL, PREP_EVAL_STRIDE = (1e-5, 1e-6), 1e-5, 8
# (c) Registration and N4 on one pair on the 3 T grid: the LR is the HR under PREP_MOTION (3 degrees about axis
# 2, 2 voxels along axis 1) and a smooth multiplicative bias field.  Limits, stated before the first run: the
# recovered angles within PREP_MOTION_TOL[0] rad and shifts within PREP_MOTION_TOL[1] voxels of the motion;
# the card's 6 parameters within PREP_CPU_TOL of the same registration on the CPU.
PREP_MOTION = (0.0, 0.0, math.radians(3.0), 0.0, 2.0, 0.0)
PREP_BIAS = (0.03, 0.015, -0.025)  # the bias field is exp(sum_i PREP_BIAS[i] * x_i), x_i in [-1, 1] along axis i
PREP_MOTION_TOL = (math.radians(0.5), 0.5)
PREP_CPU_TOL = 1e-3


def prep_head(shape, seed, peak=900.0):
    """A synthetic head on a ``shape`` grid: inside an ellipsoid (cut by the first and last axial slices),
    tissue at a fifth of ``peak`` plus ten
    smooth blobs of random sizes and intensities and Gaussian noise of 1 % of ``peak``; 0 outside; float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape], indexing="ij", sparse=True)
    vol = np.full(shape, 0.2 * peak, np.float32)
    for _ in range(10):
        c, r = rng.uniform(-0.45, 0.45, 3), rng.uniform(0.12, 0.4, 3)
        vol += np.float32(rng.uniform(0.25, 1.0) * peak) * np.exp(-sum(((g[i] - c[i]) / r[i]) ** 2 for i in range(3)))
    vol += rng.normal(0.0, 0.01 * peak, shape).astype(np.float32)
    vol *= (g[0] / 0.85) ** 2 + (g[1] / 0.92) ** 2 + (g[2] / 1.2) ** 2 < 1.0  # tissue in every axial slice
    return np.maximum(vol, 0.0)


def prep_weights(torch, tmp, converted, data_done):
    """Leg (a): the conversions (host work; ``converted`` set after them), then, once leg (b) is done with the
    card (``data_done``), ``train-latent`` and the volume, and B3 against its plain version at every (shape,
    dtype) that ``train-latent`` and the volume's capturing call gave it.  -> the path's launches:
    ``train-latent`` traced whole and one traced volume of each dispatch."""
    import os
    from pathlib import Path

    import numpy as np
    import torch.nn.functional as F
    from torch import nn

    from mrisr_torch import cli
    from mrisr_torch.data.nifti import write_nifti
    from mrisr_torch.data.safetensors_io import save_safetensors
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.convert import export_diffusers_tree
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.pipelines.latent import LatentSRPipeline
    from mrisr_torch.pipelines.volume import super_resolve_volume
    totals, weights = {}, Path(tmp) / "weights"
    weights.mkdir()
    originals = {}
    # The UNet at SD1.5's widths and PREP_UNET_CUT's depth: ``train-latent --weights-dir`` reads both towers.
    for name, make in (("unet", lambda: SDUNet(**PREP_UNET_CUT)), ("vae", AutoencoderKL)):
        torch.manual_seed(PREP_SEEDS[name])
        module = originals[name] = make()
        t0 = time.perf_counter()
        sd = export_diffusers_tree(module)
        t1 = time.perf_counter()
        src = f"{tmp}/{name}.safetensors"
        save_safetensors(src, sd)
        t2 = time.perf_counter()
        n_tensors, n_bytes = len(sd), sum(a.nbytes for a in sd.values())
        del sd
        res = cli.run(["convert-weights", "--model", name, "--input", src, "--output", str(weights / f"{name}.npz")])
        emit({"phase": "prep_weights", "model": name, "tensors": n_tensors, "fp32_bytes": n_bytes,
              "npz_bytes": os.path.getsize(weights / f"{name}.npz"), "export_s": t1 - t0,
              "safetensors_write_s": t2 - t1, "convert_weights_s": time.perf_counter() - t2,
              "read_s": res["read_s"], "convert_s": res["convert_s"], "write_s": res["write_s"],
              **({"cut": PREP_UNET_CUT} if name == "unet" else {})})
        os.remove(src)
    converted.set()
    t0 = time.perf_counter()
    data_done.wait()
    emit({"phase": "prep_weights", "waited_for_leg_b_s": time.perf_counter() - t0})
    torch.manual_seed(PREP_SEEDS["controlnet"])
    cn = ControlNet(**PREP_UNET_CUT)  # the serving ControlNet, of the converted UNet's shape
    for name, m in cn.named_modules():  # zero convs given random values, as ``latent_modules`` does
        if isinstance(m, nn.Conv2d) and (name.startswith("controlnet_") or name.endswith("cond_embedding.conv_out")):
            m.reset_parameters()
    expect = latent_train_expect(originals["unet"], cn, originals["vae"], "controlnet", 256, False,
                                 stated=PREP_TRAIN_STATED)
    # ``train-latent`` reads both .npz files into fresh towers (``load_flax_params``; the UNet at the tree's
    # depth, ``sd_unet_shape``), which it keeps frozen: each held bitwise to its original.
    argv = ["train-latent", *PREP_TRAIN, "--weights-dir", str(weights), "--out", f"{tmp}/tl"]
    (res, counts, trace), heads = recording_heads(lambda: traced_command(
        torch, "train-latent --weights-dir", lambda: cli.run(argv), lambda r: r["step"].graph, expect, 2))
    add_counts(totals, counts)
    state = res["state"]
    reloaded = {}
    for name in ("unet", "vae"):
        mine = dict(originals[name].named_parameters())
        same = [torch.equal(p, mine[k]) for k, p in res[name].named_parameters()]
        reloaded[name] = {"parameters": len(same), "bitwise_equal": sum(same)}
    reloaded["unet"]["cut"] = PREP_UNET_CUT
    ok = (state.step == 2 and all(v["parameters"] == v["bitwise_equal"] > 0 for v in reloaded.values())
          and all(bool(torch.isfinite(p).all()) for p in state.params.values()))
    emit({"phase": "prep_train_latent", **trace, **_run_record(f"{tmp}/tl"), "step": state.step,
          "reloaded_towers": reloaded, "ok": ok})
    if not ok:
        raise AssertionError(f"prep: train-latent --weights-dir: step {state.step}, reloaded towers {reloaded}")
    converted = {"unet": res["unet"], "vae": res["vae"]}
    del res, state, originals
    release_memory(torch, "prep train-latent")

    prompt = torch.randn((1, *PREP_CONTEXT), generator=torch.Generator().manual_seed(PREP_SEEDS["prompt"]))
    pipe = LatentSRPipeline(converted["unet"].to(torch.bfloat16), cn.to(torch.bfloat16),
                            converted["vae"].to(torch.bfloat16), sd15_schedule(), prompt.to(torch.bfloat16),
                            device="cuda")
    rng = np.random.default_rng(64)
    vol = prep_head(PREP_VOLUME, 65, peak=1000.0) + rng.normal(0, 5, PREP_VOLUME).astype(np.float32)
    src = f"{tmp}/volume.nii"
    write_nifti(src, vol, np.eye(4))
    kw = dict(resolution=PREP_VOLUME[0], batch_size=PREP_VOLUME_BATCH, num_steps=LATENT_STEPS, seed=9)
    n_batches = -(-PREP_VOLUME[2] // PREP_VOLUME_BATCH)
    _, volume_heads = recording_heads(lambda: super_resolve_volume(pipe, src, **kw))  # warm-up and capture
    for key, calls in volume_heads.items():
        heads[key] = heads.get(key, 0) + calls
    runs, launches = {1: [], PREP_VOLUME_GROUP: []}, {}
    for group in (1, PREP_VOLUME_GROUP, PREP_VOLUME_GROUP, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = super_resolve_volume(pipe, src, f"{tmp}/sr_{group}.nii", chain_group=group, **kw)
        runs[group].append((time.perf_counter() - t0, img.data))
    profs = {}
    for group in (1, PREP_VOLUME_GROUP):
        img, launches[group], profs[group] = replayed(
            torch, lambda g=group: super_resolve_volume(pipe, src, chain_group=g, **kw), pipe, n_batches,
            f"prep volume G={group}", None, latent_expect(pipe, PREP_VOLUME[0], LATENT_STEPS))
        runs[group].append((None, img.data))
        add_counts(totals, launches[group])
    first = runs[1][0][1]
    same = all(np.array_equal(d, first) for rs in runs.values() for _, d in rs)
    ok = same and first.shape == PREP_VOLUME and bool(np.isfinite(first).all())
    emit({"phase": "prep_volume", "shape": list(PREP_VOLUME), "batch": PREP_VOLUME_BATCH, "steps": LATENT_STEPS,
          "weights": "converted .npz, bf16", "mode": pipe.mode,
          "s_per_volume": {f"G={g}": [t for t, _ in rs if t is not None] for g, rs in runs.items()},
          "launches": {f"G={g}": c for g, c in launches.items()},
          "launches_from": "the graph's kernel nodes times the graph launches in a trace of one volume each",
          "device_busy_ms": {f"G={g}": p["device_busy_ms"] for g, p in profs.items()},
          "serial_equals_grouped": same, "out_range": [float(first.min()), float(first.max())], "ok": ok})
    if not ok:
        raise AssertionError("prep: the latent volume served serially differs from the grouped one")
    del pipe, converted, cn
    release_memory(torch, "prep volume")
    for (shape, groups, eps, dtype), calls in sorted(heads.items(), key=lambda kv: -math.prod(kv[0][0])):
        rec = check_gn(torch, F, dtype, "prep_head", shape, groups, timed=False, eps=eps)
        emit({"phase": "prep_head", "shape": list(shape), "groups": groups, "eps": eps, "dtype": rec["dtype"],
              "calls_in_capturing_calls": calls})
    return totals


def prep_bids(root, subjects):
    """The BIDS tree of leg (b): ``64mT data/sub-*/ses-1/anat/*_T1w.nii.gz`` and ``3T data/sub-*/anat/
    *_acq-highres_T1w.nii.gz`` (int16, as scanners store them)."""
    import numpy as np

    from mrisr_torch.data.nifti import write_nifti

    for i in range(subjects):
        sid = f"sub-{i + 1:04d}"
        lr_dir, hr_dir = root / "64mT data" / sid / "ses-1" / "anat", root / "3T data" / sid / "anat"
        lr_dir.mkdir(parents=True)
        hr_dir.mkdir(parents=True)
        write_nifti(lr_dir / f"{sid}_ses-1_T1w.nii.gz", prep_head(PREP_LR_GRID, 70 + i, 1800.0).astype(np.int16),
                    np.diag([*PREP_LR_AFFINE, 1.0]))
        write_nifti(hr_dir / f"{sid}_acq-highres_T1w.nii.gz", prep_head(PREP_HR_GRID, 80 + i).astype(np.int16))


def prep_data(torch, tmp, beside):
    """Leg (b): ``stats``, ``report``, ``preprocess-slices`` (card), ``export-png``, ``evaluate`` (card) over
    the exported ``lr_images`` / ``hr_images``, and ``build-index`` over the DICOM tree; each command's
    seconds, and which host work of the other legs ran beside it (``beside()``) at its start and end.  Then
    ``preprocess-slices --cpu`` over a tree of subject 1 alone, and ``evaluate`` on the card and with
    ``--cpu`` over every ``PREP_EVAL_STRIDE``-th pair, held to the card's (``PREP_SLICES_TOL``,
    ``PREP_SCORES_RTOL``)."""
    import os
    from pathlib import Path

    import numpy as np

    from mrisr_torch import cli
    from mrisr_torch.data.dicom import write_dicom_minimal

    root, out = Path(tmp) / "bids", Path(tmp) / "prep"
    out.mkdir()
    prep_bids(root, PREP_SUBJECTS)
    patients, slices, side = PREP_DICOM
    rng = np.random.default_rng(90)
    for p in range(patients):
        d = Path(tmp) / "dicom" / f"p{p}"
        d.mkdir(parents=True)
        for s in range(slices):
            write_dicom_minimal(d / f"{s:03d}.dcm", rng.integers(0, 4000, (side, side)), patient_id=f"p{p}",
                                field_strength="3.0", series_desc="AX T2", instance_number=s + 1)
    commands = (
        ("stats", ["stats", "--data-dir", str(root), "--out", str(out / "stats.json")]),
        ("report", ["report", "--data-dir", str(root), "--out", str(out / "report")]),
        ("preprocess-slices", ["preprocess-slices", "--data-dir", str(root), "--out", str(out / "slices")]),
        ("export-png", ["export-png", "--source", str(out / "slices" / "axial"), "--dest", str(out / "png")]),
        ("evaluate", ["evaluate", "--gen", str(out / "png" / "lr_images"), "--gt", str(out / "png" / "hr_images"),
                      "--state", str(out / "evaluate.json")]),
        ("build-index", ["build-index", "--root", str(Path(tmp) / "dicom"), "--out", str(out / "index.json")]))
    recs = {}
    for name, argv in commands:
        torch.cuda.synchronize()
        at_start, t0 = beside(), time.perf_counter()
        res = cli.run(argv)
        torch.cuda.synchronize()
        recs[name] = {"s": time.perf_counter() - t0, "result": res, "beside": [at_start, beside()]}
    root1, few = Path(tmp) / "bids1", out / "png_few"
    prep_bids(root1, 1)  # subject 1 of the tree above, alone
    for folder in ("lr_images", "hr_images"):
        (few / folder).mkdir(parents=True)
        for f in sorted((out / "png" / folder).glob("*.png"))[::PREP_EVAL_STRIDE]:
            os.link(f, few / folder / f.name)
    few_args = ["--gen", str(few / "lr_images"), "--gt", str(few / "hr_images")]
    cpu_s = {}
    for name, argv in (("preprocess-slices --cpu", ["preprocess-slices", "--data-dir", str(root1), "--out",
                                                    str(out / "slices_cpu"), "--cpu"]),
                       ("evaluate few", ["evaluate", *few_args]),
                       ("evaluate few --cpu", ["evaluate", *few_args, "--cpu"])):
        t0 = time.perf_counter()
        recs[name] = {"result": cli.run(argv)}
        cpu_s[name] = time.perf_counter() - t0
    slice_err, slices_ok, n_cpu_slices = 0.0, True, 0
    for f in sorted((out / "slices_cpu" / "axial").glob("*.npz")):
        with np.load(f) as cpu_npz, np.load(out / "slices" / "axial" / f.name) as card_npz:
            for k in ("lr", "hr"):
                slice_err = max(slice_err, float(np.abs(card_npz[k] - cpu_npz[k]).max()))
                slices_ok &= bool(np.allclose(card_npz[k], cpu_npz[k], *PREP_SLICES_TOL))
        n_cpu_slices += 1
    n_slices = cli.PREPROCESS_SHAPE[2]  # slices per subject
    stats, report = recs["stats"]["result"]["stats"], recs["report"]["result"]["stats"]
    sliced, exported = recs["preprocess-slices"]["result"], recs["export-png"]["result"]["pairs"]
    scores, index = recs["evaluate"]["result"]["results"], recs["build-index"]["result"]["index"]
    few_card, few_cpu = (recs[k]["result"]["results"] for k in ("evaluate few", "evaluate few --cpu"))
    score_rel = {k: abs(few_card[k] - few_cpu[k]) / abs(few_cpu[k]) for k in ("PSNR", "SSIM", "HFEN", "NMSE")}
    card_vs_cpu = {"slices_compared": n_cpu_slices, "slices_max_abs_diff": slice_err, "slices_tol": PREP_SLICES_TOL,
                   "scores_card": few_card, "scores_cpu": few_cpu, "scores_rel_diff": score_rel,
                   "scores_rtol": PREP_SCORES_RTOL, "s": cpu_s}
    outputs = {"stats": {"paired_scans": stats["paired_scans"], "subjects": stats["overlap"]["n_subjects_in_both"]},
               "report": {"montages": len(report["montages"])},
               "preprocess-slices": {"pairs": sliced["pairs"], "slices": sliced["slices"]},
               "export-png": {"pairs": exported}, "evaluate": scores,
               "build-index": {"patients": len(index), "slices": sum(len(c) for s in index.values()
                                                                      for cs in s.values() for c in cs.values())}}
    ok = (stats["paired_scans"] == PREP_SUBJECTS and len(report["montages"]) == PREP_SUBJECTS
          and sliced["slices"] == [n_slices] * PREP_SUBJECTS and exported == n_slices * PREP_SUBJECTS
          and scores is not None and scores["count"] == exported and all(math.isfinite(v) for v in scores.values())
          and outputs["build-index"] == {"patients": patients, "slices": patients * slices}
          and slices_ok and n_cpu_slices == n_slices
          and few_card["count"] == few_cpu["count"] == -(-exported // PREP_EVAL_STRIDE)
          and all(v <= PREP_SCORES_RTOL for v in score_rel.values()))
    emit({"phase": "prep_data", "lr_grid": list(PREP_LR_GRID), "hr_grid": list(PREP_HR_GRID),
          "subjects": PREP_SUBJECTS, "dicom": {"patients": patients, "slices": slices, "side": side},
          "seconds": {k: r["s"] for k, r in recs.items() if "s" in r},
          "beside": {k: r["beside"] for k, r in recs.items() if "beside" in r},
          "s_per_volume": {"preprocess-slices": recs["preprocess-slices"]["s"] / (2 * PREP_SUBJECTS),
                           "report": recs["report"]["s"] / (2 * PREP_SUBJECTS)},
          "outputs": outputs, "card_vs_cpu": card_vs_cpu, "ok": ok})
    if not ok:
        raise AssertionError(f"prep: a data command's output is not what it should be, or the card's differs "
                             f"from the CPU's: {outputs} {card_vs_cpu}")


def prep_pair(torch, device="cuda"):
    """Leg (c)'s pair on the 3 T grid: (HR, LR), the LR the HR under ``PREP_MOTION`` (warped on ``device``)
    times the bias field ``PREP_BIAS``."""
    import numpy as np

    from mrisr_torch.data import registration

    hr = prep_head(PREP_HR_GRID, 85)
    rot = registration._euler_matrix(torch.tensor(PREP_MOTION[:3], dtype=torch.float64)).numpy()
    inverse = np.concatenate([-np.asarray(PREP_MOTION[:3]), -rot.T @ np.asarray(PREP_MOTION[3:])])
    moved = registration.warp_rigid(hr, torch.tensor(inverse, dtype=torch.float32, device=device), hr.shape)
    g = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in PREP_HR_GRID], indexing="ij", sparse=True)
    return hr, moved * np.exp(sum(c * x for c, x in zip(PREP_BIAS, g)))


def prep_registration(torch, tmp, hr, lr, card_free, n4_done, device="cuda"):
    """Leg (c): ``SliceDataset(do_n4=True, register_fn=...)`` over the pair (``prep_pair``): N4 seconds
    (host; ``n4_done`` set when both volumes are corrected), the registration's on the card once
    ``card_free`` is set, its 6 parameters against the motion and against the same registration on the CPU.
    -> the record (``prep_check`` raises on a failed one)."""
    from pathlib import Path

    import numpy as np

    from mrisr_torch.data import bias_correction, registration
    from mrisr_torch.data.bids import get_data_dicts
    from mrisr_torch.data.datasets import SliceDataset
    from mrisr_torch.data.nifti import write_nifti

    root = Path(tmp) / "pair"
    (root / "64mT data" / "sub-0001" / "ses-1" / "anat").mkdir(parents=True)
    (root / "3T data" / "sub-0001" / "anat").mkdir(parents=True)
    write_nifti(root / "64mT data" / "sub-0001" / "ses-1" / "anat" / "sub-0001_ses-1_T1w.nii.gz", lr)
    write_nifti(root / "3T data" / "sub-0001" / "anat" / "sub-0001_acq-highres_T1w.nii.gz", hr)
    g = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in PREP_HR_GRID], indexing="ij", sparse=True)

    timings, seen, local = {"n4_s": [], "n4_iterations": []}, {}, threading.local()
    n4 = bias_correction.n4_bias_correction
    smooth = bias_correction._smooth_field

    def counted_smooth(*args):
        local.iterations += 1
        return smooth(*args)

    def timed_n4(volume, *args, **kw):  # the dataset corrects its two volumes on a thread each
        local.iterations = 0
        t0 = time.perf_counter()
        out = n4(volume, *args, **{**kw, "max_iterations": PREP_N4_ITERATIONS})
        timings["n4_s"].append(time.perf_counter() - t0)
        timings["n4_iterations"].append(local.iterations)
        return out

    def register(fixed, moving):
        seen.update(fixed=fixed, moving=moving)
        # the same registration on the CPU (the comparison's), on a thread while the card is awaited
        seen["cpu"] = on_host_thread(torch, lambda: registration.rigid_params(fixed, moving, device="cpu").numpy(),
                                     no_grad=False)
        n4_done.set()
        t_wait = time.perf_counter()
        timings["n4_wall_s"] = t_wait - t_start
        card_free.wait()
        t0 = time.perf_counter()
        timings["register_waited_s"] = t0 - t_wait
        params = registration.rigid_params(fixed, moving, device=device)
        params.cpu()  # waits for the device
        t1 = time.perf_counter()
        out = registration.warp_rigid(moving, params, fixed.shape)
        timings.update(register_fit_s=t1 - t0, register_warp_s=time.perf_counter() - t1)
        seen["params"] = params.cpu().numpy()
        return out

    bias_correction.n4_bias_correction, bias_correction._smooth_field = timed_n4, counted_smooth
    try:
        t_start = time.perf_counter()
        ds = SliceDataset(get_data_dicts(root), cache_dir=Path(tmp) / "cache", do_n4=True, register_fn=register)
        dataset_s = time.perf_counter() - t_start
    finally:
        bias_correction.n4_bias_correction, bias_correction._smooth_field = n4, smooth
    cpu, cpu_s = seen["cpu"].result()
    card = seen["params"]
    item = ds[len(ds) // 2]
    inside = lr > 0  # the field N4 found in the LR against the one put in (log domain, inside the head)
    found = np.log(lr[inside] / np.maximum(seen["moving"][inside], 1e-6))
    put = sum(c * x for c, x in zip(PREP_BIAS, g)) * np.ones(lr.shape, np.float32)
    put = put[inside]
    motion_err = np.abs(card - np.asarray(PREP_MOTION))
    ok = (len(ds) == PREP_HR_GRID[2] - 110 and bool(np.isfinite(item["lr"]).all())
          and bool((motion_err[:3] <= PREP_MOTION_TOL[0]).all()) and bool((motion_err[3:] <= PREP_MOTION_TOL[1]).all())
          and float(np.abs(card - cpu).max()) <= PREP_CPU_TOL)
    return {"phase": "prep_registration", "grid": list(PREP_HR_GRID), "motion": list(PREP_MOTION),
          "simpleitk": registration._has_sitk(), "card_params": card.tolist(), "cpu_params": cpu.tolist(),
          "motion_abs_err": motion_err.tolist(), "motion_tol": list(PREP_MOTION_TOL),
          "card_vs_cpu_max_abs": float(np.abs(card - cpu).max()), "card_vs_cpu_tol": PREP_CPU_TOL,
          "cpu_register_fit_s": cpu_s, "dataset_s": dataset_s, "slices": len(ds),
          "n4_max_iterations": PREP_N4_ITERATIONS, **timings,
          "n4_field_log_std": float(found.std()), "bias_log_std": float(put.std()),
          "n4_field_corr": float(np.corrcoef(found, put)[0, 1]), "ok": ok}


def prep_check(rec):
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"prep: registration recovered {rec['card_params']} for {PREP_MOTION} (CPU "
                             f"{rec['cpu_params']}), or the dataset is wrong ({rec['slices']} slices)")


def phase_prep(torch):
    """Weights converted and trained and served from, data prepared and scored, a pair registered after N4
    (``prep_weights``, ``prep_data``, ``prep_registration``).  Legs (b) and (c) run on threads beside (a),
    whose conversions are minutes of host work on one core, as is (c)'s N4 on two: (a) waits for (b) before
    its card work, and (c)'s registration waits until (a) is done with the card.  -> the path's launches
    (leg (a)'s)."""
    import tempfile

    hr, lr = prep_pair(torch)
    card_free, n4_done, converted, data_done = (threading.Event() for _ in range(4))
    result, errors = {}, {}

    def leg(name, run, done=None):
        try:
            result[name] = run()
        except BaseException as e:  # re-raised below, in the phase's own thread
            errors[name] = e
        finally:
            if done is not None:
                done.set()

    beside = lambda: {"n4": not n4_done.is_set(), "conversions": not converted.is_set()}  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp_b, tempfile.TemporaryDirectory() as tmp_c:
        threads = [threading.Thread(target=leg, args=("data", lambda: prep_data(torch, tmp_b, beside), data_done),
                                    name="prep-data"),
                   threading.Thread(target=leg, args=("registration", lambda: prep_registration(
                       torch, tmp_c, hr, lr, card_free, n4_done)), name="prep-registration")]
        for thread in threads:
            thread.start()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                totals = prep_weights(torch, tmp, converted, data_done)
        finally:
            t0 = time.perf_counter()
            converted.set()
            card_free.set()
            for thread in threads:
                thread.join()
        if errors:
            raise next(iter(errors.values()))
    prep_check({**result["registration"], "joined_after_s": time.perf_counter() - t0})
    return totals

# Phase ``parity``: the fidelity harness through the command line.  (a) ``parity`` at PARITY_r07_256.json's
# configuration (256^2, the main path's UNet, bs 8, cosine, EMA 0.999, seeds 2 and 3, the reference's chain
# lengths at 256^2), fp32 throughout; (b) ``parity-latent`` at PARITY_r09.json's widths; (c) ``train-mnist``.
# Only depth and set sizes are cut, each named in the phase's output beside the record's value.
PARITY_ARGV = ["parity", "--resolution", str(SIZE), "--inner-channel", "32", "--batch", str(BATCH),
               "--lr-schedule", "cosine", "--ema-decay", "0.999", "--sample-seeds", "2,3"]
PARITY_CUTS = {"--sample-steps": ("10,50,250", "10,50,100"), "--n-train": (384, 64),
               "--phantom-steps": (2000, 400), "--resdiff-steps": (60000, 100), "--chunk-steps": (250, 100),
               "--eval-every": (2500, 100), "--n-test": (64, 8), "--mnist-steps": ("not run (--skip-mnist)", 100)}
PARITY_LATENT_ARGV = ["parity-latent", "--resolution", str(SIZE), "--vae-width", "32", "--unet-width", "64",
                      "--cache-latents", "--prediction-type", "sample", "--inference-steps", "20",
                      "--sample-seeds", "2,3", "--batch", str(BATCH)]
PARITY_LATENT_CUTS = {"--n-train": (512, 16), "--n-test": (32, 8), "--vae-steps": (8000, 2),
                      "--base-steps": (10000, 2), "--cn-steps": (8000, 2), "--lora-steps": (5000, 2),
                      "--adapter-steps": (4000, 2), "--cn-lora-steps": (6000, 2), "--chunk-steps": (250, 2),
                      "--vae-chunk-steps": (64, 2), "--extra-sample-steps": ("50", "")}
PARITY_MNIST_STEPS, PARITY_MNIST_RESUME = 20, 10  # train-mnist: steps a mode; the ddpm run resumed for 10 more
MNIST_LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                  "group_norm_silu": 15}  # a step: 7 ResnetBlocks x 2 ConvBlock heads + the final GN -> swish
PARITY_RESUME = (4, 2)  # the resume check: steps of the uninterrupted run, and where the other run stops


def _cut_argv(cuts):
    return [x for flag, (_, now) in cuts.items() if now != "" for x in (flag, str(now))]


def _profile_name(unet):
    pool, tokens = unet.ca_kv_pool, unet.ca_kv_pool_min_tokens
    return "exact" if not pool else f"kv_pool_{pool}" if tokens <= 4096 else f"selective_{pool}"


class _ParityRecorder:
    """Wraps ``ResDiffPipeline.super_resolve`` and the harness's legs and training for leg (a): each chain's
    seconds by profile and length (the first of a shape and length captures its graph), each 50-step chain's
    starting noise by profile, and one traced 50-step replay a profile (``replayed``: the graph's kernel
    nodes, the graph launches in the trace, the trace's kernel records)."""

    def __init__(self, torch):
        from mrisr_torch.eval import parity
        from mrisr_torch.pipelines.resdiff import ResDiffPipeline

        self.torch, self.parity, self.cls = torch, parity, ResDiffPipeline
        self.chains, self.noise, self.traces, self.launches, self.legs, self.train = {}, {}, {}, {}, {}, []
        self.saved = {}

    def __enter__(self):
        torch, rec = self.torch, self
        real = self.cls.super_resolve

        def super_resolve(pipe, lr, generator=None, x_T=None, num_steps=50, spacing="trailing"):
            name = _profile_name(pipe.unet)
            key = (tuple(lr.shape), lr.dtype, num_steps, spacing)
            captured = key in pipe.graphs
            if x_T is not None and num_steps == STEPS:
                rec.noise.setdefault(name, []).append(x_T.clone())
            run = lambda: real(pipe, lr, generator, x_T, num_steps, spacing)  # noqa: E731
            if captured and num_steps == STEPS and name not in rec.traces:
                out, launches, prof = replayed(torch, run, _OneGraph(pipe.graphs[key]), 1, f"parity {name}",
                                               expect=chain_expect(STEPS))
                rec.traces[name] = {k: prof[k] for k in ("graph_kernel_nodes", "graph_launches", "kernel_events",
                                                         "trace_missed", "device_busy_ms", "profiled_chain_ms")}
                add_counts(rec.launches, launches)
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            rec.chains.setdefault((name, num_steps, "capture" if not captured else "replay"), []).append(
                time.perf_counter() - t0)
            return out

        def timed_leg(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                rec.legs[name] = time.perf_counter() - t0
                return out
            return run

        def timed_many(fn):
            def make(*a, **kw):
                many = fn(*a, **kw)

                def run(state, sr_all, hr_all, idx, step_ids, seed):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = many(state, sr_all, hr_all, idx, step_ids, seed)
                    torch.cuda.synchronize()
                    rec.train.append({"steps": len(idx), "s": time.perf_counter() - t0})
                    return out
                return run
            return make

        p = self.parity
        self.saved = {"super_resolve": real, "make_resdiff_train_many": p.make_resdiff_train_many,
                      **{n: getattr(p, n) for n in ("run_mnist", "run_phantom_cnn", "run_phantom_resdiff")}}
        self.cls.super_resolve = super_resolve
        p.make_resdiff_train_many = timed_many(self.saved["make_resdiff_train_many"])
        for n in ("run_mnist", "run_phantom_cnn", "run_phantom_resdiff"):
            setattr(p, n, timed_leg(n, self.saved[n]))
        return self

    def __exit__(self, *exc):
        self.cls.super_resolve = self.saved.pop("super_resolve")
        for n, fn in self.saved.items():
            setattr(self.parity, n, fn)


def parity_resume(torch):
    """``train_phantom_resdiff`` (the harness's stage-2 loop) at leg (a)'s configuration, 4 steps in chunks of 2
    with ``--ckpt`` at each, against 2 steps and then a resume from the checkpoint to 4 (deterministic cuDNN):
    every tensor of the state bitwise equal.  The resumed run is traced whole (``traced_command``): the
    training step's graph, its kernel nodes and its 2 replays.  -> (record, launches)."""
    import tempfile

    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.eval import parity
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.train import steps as steps_mod
    from mrisr_torch.train.state import cosine_decay_schedule, create_train_state, make_optimizer

    total, cut = PARITY_RESUME
    lr_all, hr_all = parity._phantom_batches(16, SIZE)
    torch.manual_seed(0)
    cnn = SimpleCNN(device="cuda")
    with torch.no_grad():
        sr = cnn(torch.from_numpy(lr_all).cuda().permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
    hr = torch.from_numpy(hr_all).cuda()
    torch.manual_seed(1)
    init = {k: v.detach().clone() for k, v in ResDiffUNet(image_size=SIZE, inner_channel=32, norm_groups=8,
                                                          device="cuda").named_parameters()}
    graphs = []

    class Recorded(steps_mod.GraphedStep):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            graphs.append(self)

    def fresh():
        unet = ResDiffUNet(image_size=SIZE, inner_channel=32, norm_groups=8, device="cuda")
        parity._load_(unet, init)
        tx = make_optimizer(cosine_decay_schedule(2e-4, total, alpha=0.05))
        return unet, create_train_state(unet, tx, ema_decay=0.999, device="cuda")

    sched = resdiff_schedule(1000)
    torch.backends.cudnn.deterministic = True
    real = steps_mod.GraphedStep
    steps_mod.GraphedStep = Recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            unet, whole = fresh()
            t0 = time.perf_counter()
            whole, _ = parity.train_phantom_resdiff(unet, sched, whole, sr, hr, BATCH, total, cut, cut,
                                                    f"{tmp}/whole.pt")
            whole_s = time.perf_counter() - t0
            unet, part = fresh()
            parity.train_phantom_resdiff(unet, sched, part, sr, hr, BATCH, cut, cut, cut, f"{tmp}/part.pt")
            saved = open(f"{tmp}/part.pt", "rb").read()

            def resume():  # from the checkpoint the first run left, again on each trace
                open(f"{tmp}/resumed.pt", "wb").write(saved)
                unet, state = fresh()
                return parity.train_phantom_resdiff(unet, sched, state, sr, hr, BATCH, total, cut, cut,
                                                    f"{tmp}/resumed.pt", f"{tmp}/resumed.pt")[0]

            resumed, launches, trace = traced_command(torch, "train_phantom_resdiff --resume-ckpt", resume,
                                                      lambda _: graphs[-1].graph, TRAIN_LAUNCHES, total - cut)
    finally:
        steps_mod.GraphedStep = real
        torch.backends.cudnn.deterministic = False
    same = [torch.equal(a, b) for a, b in zip(_state_tensors(resumed), _state_tensors(whole), strict=True)]
    rec = {"phase": "parity", "check": "resume", "steps": total, "resumed_at": cut, "cudnn": "deterministic",
           "step": resumed.step, "resumed_equals_uninterrupted": all(same), "tensors_compared": len(same),
           "tensors_differing": same.count(False), "uninterrupted_s": whole_s, **trace}
    emit(rec)
    if not all(same) or resumed.step != total or whole.step != total:
        raise AssertionError(f"parity: the resumed stage-2 run differs from the uninterrupted one: {rec}")
    return launches


def parity_harness(torch, tmp):
    """Leg (a): ``parity`` through the command line in this process (``_ParityRecorder``)."""
    from mrisr_torch import cli

    argv = PARITY_ARGV + _cut_argv({k: v for k, v in PARITY_CUTS.items() if k != "--mnist-steps"}) + [
        "--mnist-steps", str(PARITY_CUTS["--mnist-steps"][1]), "--out", f"{tmp}/parity.json",
        "--ckpt", f"{tmp}/parity.ckpt"]
    t0 = time.perf_counter()
    with _ParityRecorder(torch) as rec:
        report = cli.run(argv)["report"]
    wall = time.perf_counter() - t0
    profiles = ["exact", "kv_pool_2", "kv_pool_4", "kv_pool_8", "selective_4", "selective_8"]
    exact = rec.noise.get("exact", [])
    paired = {name: len(rec.noise.get(name, [])) > 0 and all(
        torch.equal(a, b) for a, b in zip(rec.noise[name], exact[-len(rec.noise[name]):], strict=True))
        for name in profiles[1:]}
    rd = report["phantom_resdiff"]
    rows = {"mnist_regression": report["mnist_regression"]["model"], "mnist_bicubic":
            report["mnist_regression"]["bicubic_baseline"], "phantom_cnn": report["phantom_cnn"]["model"],
            "phantom_bicubic": report["phantom_cnn"]["bicubic_baseline"], "stage1_cnn": rd["stage1_cnn"],
            "by_sample_steps": rd["by_sample_steps"],
            "profiles_50step": {n: {"mean": v["mean"], **({k: v[k] for k in ("within_0p1db", "delta_vs_exact")
                                                          if k in v})}
                                for n, v in rd["profiles_50step"].items() if n != "sample_steps"}}
    steps_run = sum(t["steps"] for t in rec.train)
    out = {"phase": "parity", "leg": "parity", "argv": argv[1:], "cuts": {k: {"record": a, "run": b}
                                                                          for k, (a, b) in PARITY_CUTS.items()},
           "wall_s": wall, "leg_s": rec.legs, "train_chunks": rec.train,
           "train_ms_per_step_with_capture": 1e3 * sum(t["s"] for t in rec.train) / max(steps_run, 1),
           "chain_s": {f"{n} {k} {w}": v for (n, k, w), v in sorted(rec.chains.items())},
           "x_T_equal_to_exact": paired, "traced_chains": rec.traces, "rows": rows,
           "card": torch.cuda.get_device_name(0)}
    ok = (set(rec.traces) == set(profiles) and all(paired.values()) and set(rd["profiles_50step"]) ==
          {"sample_steps", *profiles} and all(math.isfinite(v) for row in (rd["model"], rd["stage1_cnn"])
                                              for v in row.values()))
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"parity: leg (a) {out}")
    return rec.launches


def parity_latent(torch, tmp):
    """Leg (b): ``parity-latent`` through the command line, every leg on; its wrapper counts (eager warm-ups
    and capture records) must hold no B1 (every attention dense at 64^2 latents: 4096 keys) and some B3."""
    from mrisr_torch import cli

    argv = PARITY_LATENT_ARGV + _cut_argv(PARITY_LATENT_CUTS) + ["--out", f"{tmp}/latent.json"]
    t0 = time.perf_counter()
    report, counts = counted(torch, lambda: cli.run(argv)["report"])
    wall = time.perf_counter() - t0
    rows = {n: {"mean": v["mean"], "beats_bicubic": v["beats_bicubic"]} for n, v in report.items()
            if isinstance(v, dict) and "beats_bicubic" in v}
    ok = (counts["flash_attention_fwd"] == 0 and counts["group_norm_silu"] > 0
          and set(rows) == {"base_unet", "controlnet", "lora", "cn_lora", "adapter"}
          and all(math.isfinite(r["mean"]["psnr"]) for r in rows.values()))
    rec = {"phase": "parity", "leg": "parity-latent", "argv": argv[1:],
           "cuts": {k: {"record": a, "run": b} for k, (a, b) in PARITY_LATENT_CUTS.items()}, "wall_s": wall,
           "wrapper_counts": counts, "scaling_factor": report["config"]["vae"]["scaling_factor"],
           "vae_recon_ceiling": report["vae_recon_ceiling"], "bicubic_baseline": report["bicubic_baseline"],
           "rows": rows, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"parity: leg (b) {rec}")


def parity_mnist(torch, tmp):
    """Leg (c): ``train-mnist`` in both modes, then the ddpm run resumed for ``PARITY_MNIST_RESUME`` steps
    (traced whole) against an uninterrupted run of as many steps, bitwise (deterministic cuDNN)."""
    import shutil

    from mrisr_torch import cli

    launches = {}
    for mode in ("regression", "ddpm"):
        argv = ["train-mnist", "--mode", mode, "--steps", str(PARITY_MNIST_STEPS), "--out", f"{tmp}/{mode}"]
        t0 = time.perf_counter()
        cli.run(argv)
        emit({"phase": "parity", "leg": "train-mnist", "argv": argv[1:], "wall_s": time.perf_counter() - t0,
              **_run_record(f"{tmp}/{mode}")})
    torch.backends.cudnn.deterministic = True
    try:
        base = ["train-mnist", "--mode", "ddpm"]
        cli.run(base + ["--steps", str(PARITY_MNIST_STEPS), "--out", f"{tmp}/part"])
        shutil.copytree(f"{tmp}/part/ckpt", f"{tmp}/part_ckpt")
        total = PARITY_MNIST_STEPS + PARITY_MNIST_RESUME

        def resume():
            shutil.rmtree(f"{tmp}/part/ckpt")
            shutil.copytree(f"{tmp}/part_ckpt", f"{tmp}/part/ckpt")
            return cli.run(base + ["--steps", str(total), "--resume", "--out", f"{tmp}/part"])

        res, counts, trace = traced_command(torch, "train-mnist --resume", resume, lambda r: r["step"].graph,
                                            MNIST_LAUNCHES, PARITY_MNIST_RESUME)
        add_counts(launches, counts)
        whole = cli.run(base + ["--steps", str(total), "--out", f"{tmp}/whole"])["state"]
    finally:
        torch.backends.cudnn.deterministic = False
    same = [torch.equal(a, b) for a, b in zip(_state_tensors(res["state"]), _state_tensors(whole), strict=True)]
    rec = {"phase": "parity", "leg": "train-mnist --resume", **trace, "resumed_equals_uninterrupted": all(same),
           "tensors_compared": len(same), "tensors_differing": same.count(False)}
    emit(rec)
    if not all(same) or res["state"].step != total:
        raise AssertionError(f"parity: train-mnist --resume differs from the uninterrupted run: {rec}")
    return launches


def phase_parity(torch):
    """The fidelity harness and the MNIST trainer on the card: legs (a) ``parity``, the resume check of its
    stage-2 loop, (b) ``parity-latent``, (c) ``train-mnist``; then B3, B1 and the B2 pair against their plain
    versions at every (shape, dtype) the legs launched them at (``recording_shapes``).  -> the path's launches:
    (a)'s traced chains (one a profile), the traced resumed training step, and (c)'s traced resumed trainer."""
    import tempfile

    import torch.nn.functional as F

    totals, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        shapes = collections.defaultdict(collections.Counter)

        def leg(name, run):
            t0 = time.perf_counter()
            out, seen = recording_shapes(run)
            seconds[name] = time.perf_counter() - t0
            for wrapper, keys in seen.items():
                shapes[wrapper].update(keys)
            gc.collect()  # the leg's graphs and their memory pools, before the next leg captures its own
            torch.cuda.empty_cache()
            return out

        add_counts(totals, leg("parity", lambda: parity_harness(torch, tmp)))
        add_counts(totals, leg("resume", lambda: parity_resume(torch)))
        leg("parity-latent", lambda: parity_latent(torch, tmp))
        add_counts(totals, leg("train-mnist", lambda: parity_mnist(torch, tmp)))
    worst = {"group_norm_silu": 0.0, "flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    t0 = time.perf_counter()
    for (shape, groups, eps, dtype) in sorted(shapes["group_norm_silu"], key=str):
        rec = check_gn(torch, F, dtype, "parity_head", shape, groups, timed=False, eps=eps)
        worst["group_norm_silu"] = max(worst["group_norm_silu"], rec["err_over_limit"])
    seconds["gn_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (b, n, m, d, dtype) in sorted(shapes["flash_attention_fwd"], key=str):
        rec = check_flash(torch, F, dtype, "parity_site", b, n, m, d, timed=False)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], rec["o_err_over_limit"])
    for (b, n, m, d, dtype) in sorted(shapes["flash_attention_bwd"], key=str):
        recs = check_flash_bwd(torch, F, dtype, "parity_site", b, n, m, d, timed=False)
        worst["flash_attention_bwd"] = max([worst["flash_attention_bwd"]] + [
            e["err_over_limit"] for r in recs.values() for e in r["errors"].values()])
    seconds["flash_checks"] = time.perf_counter() - t0
    checked = {w: sorted([list(k[:-1]) + [str(k[-1]).split(".")[-1]] for k in keys], key=str)
               for w, keys in shapes.items()}
    emit({"phase": "parity", "leg": "summary", "seconds": seconds, "shapes_checked": checked,
          "worst_err_over_limit": worst, "launches": totals})
    if not shapes["flash_attention_fwd"] or not shapes["flash_attention_bwd"]:
        raise AssertionError(f"parity: the legs launched no B1 or no B2 pair: {checked}")
    return totals


# Phase ``tail``: the port's last modules on the card.  (a) The fused ControlNet+UNet towers (the default form)
# against the towers one after the other, at SD1.5's widths; (b) the int8 profile; (c) the mesh legs of
# ``parallel/dryrun.py`` at world size 1 over NCCL; (d) SDXL's two text towers at full width against the CPU.
# Every bar is stated here, before the run.
TAIL_EPS = (512, 2)  # one fp32 eps-prediction, fused against unfused: condition size, batch
TAIL_EPS_TOL = dict(atol=2e-4, rtol=2e-4)  # the reference's own bar for fused == unfused
TAIL_CHAIN_TOL = 1e-3  # the 20-step chains (fp32 compute, bf16 weights): max |fused - unfused|, pixels in [-1, 1]
TAIL_TRAIN = (1024, 1)  # the ControlNet training step from cached latents: condition size, batch
TAIL_TRAIN_REPLAYS = 3
TAIL_GRAD_TOL = 1e-4  # fused against unfused, per parameter: ||g_fused - g_unfused|| <= TAIL_GRAD_TOL ||g_unfused||
TAIL_INT8_REPS = 2
SDXL_PROMPTS = ["a t1-weighted brain mri slice", "low field mri, axial"]
SDXL_TOL = 1e-4  # card against CPU, fp32, TF32 off: max |err| over max |ref|, prompt embeddings and pooled


def tail_eps(torch):
    """(a) One fp32 eps-prediction at ``TAIL_EPS``, fused towers against unfused (TF32 off): error, ms, launches.
    -> the fused call's B3 heads ({(shape, groups, eps, dtype): calls})."""
    from mrisr_torch.models.controlnet import embed_condition
    from mrisr_torch.models.fused import fused_eps, stack_tower_params

    unet, cn, _ = latent_modules(torch, torch.float32, seed=50)
    size, b = TAIL_EPS
    lat = size // 8
    gen = torch.Generator(device="cuda").manual_seed(51)
    x = torch.randn((b, 4, lat, lat), generator=gen, device="cuda")
    cond = torch.rand((b, 3, size, size), generator=gen, device="cuda") * 2 - 1
    ctx = torch.randn((b, 77, 768), generator=gen, device="cuda")
    t = torch.tensor([500, 20][:b] + [999] * max(0, b - 2), device="cuda")

    def unfused():
        down, mid = cn(x, t, ctx, cond_embedding=emb)
        return unet(x, t, ctx, down_block_additional_residuals=down, mid_block_additional_residual=mid)

    def fused():
        stacked = stack_tower_params(unet, dict(unet.named_parameters()), dict(cn.named_parameters()))
        return fused_eps(unet, cn, stacked, x, t, ctx, emb)

    with torch.no_grad():
        emb = embed_condition(cn, cond)
        want, unfused_counts = counted(torch, unfused)
        (got, heads), fused_counts = counted(torch, lambda: recording_heads(fused))
        ms = {"unfused": cuda_ms(torch, unfused), "fused": cuda_ms(torch, fused)}
    err = (got - want).abs()
    expect = {True: {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                     "group_norm_silu": 45},
              False: {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                      "group_norm_silu": 65}}
    ok = (bool((err <= TAIL_EPS_TOL["atol"] + TAIL_EPS_TOL["rtol"] * want.abs()).all())
          and fused_counts == expect[True] and unfused_counts == expect[False])
    rec = {"phase": "tail", "leg": "fused_eps", "size": size, "batch": b, "dtype": "float32", "tf32": False,
           "max_abs_err": float(err.max()), "ref_abs_max": float(want.abs().max()),
           "rms_err_over_rms_ref": float(err.square().mean().sqrt() / want.square().mean().sqrt()),
           "tolerance": TAIL_EPS_TOL, "ms": ms, "launches": {"fused": fused_counts, "unfused": unfused_counts},
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"tail: the fused eps-prediction disagrees with the unfused one: {rec}")
    del unet, cn
    return heads


def tail_chains(torch, totals):
    """(a) The graphed 512^2 bs-8 and 1024^2 bs-2 ControlNet chains (phase ``latent``'s modules and inputs) in
    both forms: the unfused ones here (first call: warm-up, capture and a replay, counted; then one replay
    traced, ``replayed``), the fused ones from phase ``latent`` (or here, when it did not run); ms of the
    traced replay, its launches (the graph's kernel nodes times the graph launches in its trace), and the two
    outputs compared."""
    prompt = torch.randn((1, 77, 768), generator=torch.Generator().manual_seed(20)).to(torch.bfloat16)
    unet, cn, vae = latent_modules(torch, torch.bfloat16)
    for case, batch, size in LATENT_CHAINS:
        runs = {}
        for fused in (True, False):
            if (size, fused) in LATENT_RUNS:
                runs[fused] = dict(LATENT_RUNS[size, fused], source="phase latent (traced replay's wall)")
                continue
            pipe, expect = latent_pipeline(torch, unet, cn, vae, prompt, size, fused=fused)
            lr, noise = latent_inputs(torch, pipe, batch, size)
            run = lambda: pipe.super_resolve(lr, num_steps=LATENT_STEPS, noise=noise)  # noqa: E731,B023
            what = f"tail latent {size} fused={fused}"
            t0 = time.perf_counter()
            _, first = counted(torch, run)  # eager warm-up, capture (counted), one replay
            first_s = time.perf_counter() - t0
            if first != {k: 2 * n for k, n in expect.items()}:
                raise AssertionError(f"{what}: first call {first}, expected twice {expect}")
            add_counts(totals, first)
            out, launches, prof = replayed(torch, run, pipe, 1, f"{what} graph replay", None, expect)
            add_counts(totals, launches)
            runs[fused] = {"out": out, "chain_ms": prof["profiled_chain_ms"], "launches": launches,
                           "first_call_s": first_s, "source": "phase tail (traced replay's wall)"}
            del pipe
            release_memory(torch, f"tail latent {size} fused={fused}")
        diff = (runs[True]["out"].float() - runs[False]["out"].float()).abs()
        ok = float(diff.max()) <= TAIL_CHAIN_TOL
        emit({"phase": "tail", "leg": "fused_chain", "case": case, "batch": batch, "size": size,
              "steps": LATENT_STEPS, "weights": "bfloat16", **{
                  ("fused" if f else "unfused"): {k: v for k, v in r.items() if k != "out"} for f, r in runs.items()},
              "fused_over_unfused_ms": runs[True]["chain_ms"] / runs[False]["chain_ms"],
              "max_abs_diff": float(diff.max()), "rms_diff": float(diff.square().mean().sqrt()),
              "tolerance": TAIL_CHAIN_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"tail: the fused and unfused {size}^2 chains differ by {float(diff.max())}")
    del unet, cn, vae


def tail_train(torch, totals):
    """(a) The 1024^2 ControlNet training step from cached latents (fp32, phase ``latent_train``'s modules) in
    both forms: graphed (first call: two eager warm-ups, the capture and a replay, counted), then
    ``TAIL_TRAIN_REPLAYS`` replays traced (``replayed``: their launches are the graph's kernel nodes times the
    graph launches in the trace, ms a step their traced wall over the replays); then one eager step of each
    with fixed draws, gradient by gradient."""
    from mrisr_torch.diffusion.schedules import sd15_schedule
    from mrisr_torch.train import latent
    from mrisr_torch.train.state import Optimizer, create_train_state
    from mrisr_torch.train.steps import step_generator

    torch.backends.cudnn.deterministic = True
    unet, cn, vae = latent_modules(torch, torch.float32, seed=40)
    gen = torch.Generator().manual_seed(45)
    prompt = (0.02 * torch.randn((1, 77, 768), generator=gen)).cuda()
    empty = torch.zeros((1, 77, 768), device="cuda")
    size, batch = TAIL_TRAIN
    lat = size // 8
    data = latent_train_batch(torch, batch, size, 42, vae)
    rec = {"phase": "tail", "leg": "fused_train_step", "size": size, "batch": batch, "cached_latents": True,
           "dtype": "float32"}
    for fused in (True, False):
        expect = latent_train_expect(unet, cn, vae, "controlnet", size, True, fused)
        state, step = latent_train_step(torch, unet, cn, vae, "controlnet", True, prompt, empty, fused=fused)
        _, first = counted(torch, lambda: step(state, data, step_generator(43, 0, "cuda")))  # noqa: B023
        if first != {k: 3 * n for k, n in expect.items()}:
            raise AssertionError(f"tail: train step fused={fused}: first call {first}, expected three times "
                                 f"{expect}")
        add_counts(totals, first)

        def replays(state=state, step=step):
            for i in range(TAIL_TRAIN_REPLAYS):
                step(state, data, step_generator(43, 1 + i, "cuda"))

        _, launches, prof = replayed(torch, replays, _OneGraph(step), TAIL_TRAIN_REPLAYS,
                                     f"tail train step fused={fused} replays", None, expect)
        add_counts(totals, launches)
        rec["fused" if fused else "unfused"] = {
            "step_ms": prof["profiled_chain_ms"] / TAIL_TRAIN_REPLAYS, "launches": launches,
            "graph_kernel_nodes": prof["graph_kernel_nodes"], "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step
        release_memory(torch, f"tail train fused={fused}")
    sched = sd15_schedule()
    g = torch.Generator(device="cuda").manual_seed(44)
    draws = {k: torch.randn((batch, 4, lat, lat), generator=g, device="cuda") for k in ("hr_noise", "lr_noise", "eps")}
    draws["t"] = torch.tensor([400] * batch, device="cuda")
    grads, losses = {}, {}
    for fused in (True, False):
        seen = {}

        def record(gr, opt_state, params, seen=seen):  # keeps the gradients, moves nothing
            seen.update(gr)
            return {k: torch.zeros_like(v) for k, v in gr.items()}, opt_state

        state = create_train_state(cn, Optimizer(lambda p: {}, record), device="cuda")
        step = latent.make_controlnet_train_step(unet, cn, vae, sched, prompt, latents_cached=True, device="cuda",
                                                 cuda_graph=False, fused=fused)
        _, m = step(state, data, None, draws)
        grads[fused], losses[fused] = {k: v.clone() for k, v in seen.items()}, float(m["loss"])
        del state, step
    rel = {k: float((grads[True][k] - g_).norm() / g_.norm().clamp_min(1e-30)) for k, g_ in grads[False].items()}
    worst = max(rel, key=rel.get)
    ok = rel[worst] <= TAIL_GRAD_TOL and abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False])
    rec.update(fused_over_unfused_ms=rec["fused"]["step_ms"] / rec["unfused"]["step_ms"],
               loss=losses, leaves=len(rel), worst_leaf=worst, worst_rel_l2=rel[worst],
               median_rel_l2=sorted(rel.values())[len(rel) // 2], tolerance=TAIL_GRAD_TOL, ok=ok)
    emit(rec)
    torch.backends.cudnn.deterministic = False
    if not ok:
        raise AssertionError(f"tail: the fused training step's gradients differ from the unfused one's: {rec}")
    del unet, cn, vae, grads


def tail_int8(torch, totals):
    """(b) ``int8_conv`` on the card against its plain version on the CPU at every int8 conv shape of the bs-8
    256^2 UNet (bitwise), each timed beside the exact bf16 conv; the bs-8 bf16 fast chain with ``conv_int8``
    (graphed: launches from its nodes, ms) beside the same chain exact; the int8 profile on the trained
    checkpoint against exact, one eager chain each, PSNR per image (fp32; information, no bar).  Each graphed
    chain's first call (warm-up, capture, a replay) is counted, then ``TAIL_INT8_REPS`` replays are traced
    (``replayed``: launches from the graph's kernel nodes times the graph launches in the trace)."""
    import numpy as np
    import torch.nn.functional as F

    from mrisr_torch.models.layers import PlainConvInt8
    from mrisr_torch.ops.quant import int8_conv
    from mrisr_torch.utils.flax_msgpack import read_msgpack

    pipe = serving_pipeline(torch, 8, conv_int8=True)
    shapes = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.update([(tuple(args[0].shape), tuple(mod.weight.shape))]))
        for m in pipe.unet.modules() if isinstance(m, PlainConvInt8)]
    gen = torch.Generator(device="cuda").manual_seed(60)
    with torch.no_grad():
        pipe.unet(torch.randn((BATCH, 2, SIZE, SIZE), generator=gen, device="cuda").to(torch.bfloat16),
                  torch.rand((BATCH,), generator=gen, device="cuda"))
    for h in hooks:
        h.remove()
    convs, cpu_inputs = [], []
    for (xs, ws), calls in sorted(shapes.items(), key=lambda kv: -math.prod(kv[0][0])):
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(ws, generator=gen, device="cuda") / math.sqrt(ws[1] * 9)).to(torch.bfloat16)
        b = (0.1 * torch.randn(ws[:1], generator=gen, device="cuda")).to(torch.bfloat16)
        convs.append({"x": list(xs), "w": list(ws), "calls_a_step": calls, "got": int8_conv(x, w, b).cpu(),
                      "int8_ms": cuda_ms(torch, lambda: int8_conv(x, w, b), 50.0),  # noqa: B023
                      "exact_bf16_ms": cuda_ms(torch, lambda: F.conv2d(x, w, b, padding=1), 50.0)})  # noqa: B023
        cpu_inputs.append((x.cpu(), w.cpu(), b.cpu()))

    def plain_on_cpu():  # host work: on a thread beside the chains below
        out = []
        for args in cpu_inputs:
            t0 = time.perf_counter()
            out.append((int8_conv(*args), time.perf_counter() - t0))
        return out

    plain = concurrent.futures.ThreadPoolExecutor(1).submit(plain_on_cpu)
    lr = (torch.rand((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    x_T = torch.randn((BATCH, SIZE, SIZE, 1), generator=gen, device="cuda").to(torch.bfloat16)
    chains = {}
    for name, p in (("int8", pipe), ("exact_convs", None)):
        p = p or serving_pipeline(torch, 8)
        run = lambda: p.super_resolve(lr, x_T=x_T, num_steps=STEPS)  # noqa: E731,B023
        out, first = counted(torch, run)
        if first != {k: 2 * n for k, n in chain_expect(STEPS).items()}:
            raise AssertionError(f"tail: {name} chain: first call {first}")
        add_counts(totals, first)
        _, launches, prof = replayed(torch, lambda: [run() for _ in range(TAIL_INT8_REPS)],  # noqa: B023
                                     p, TAIL_INT8_REPS, f"tail {name} chain replays", None, chain_expect(STEPS))
        add_counts(totals, launches)
        chains[name] = {"chain_ms": prof["profiled_chain_ms"] / TAIL_INT8_REPS, "launches": launches,
                        "graph_kernel_nodes": prof["graph_kernel_nodes"], "out": out}
        del p
    diff = (chains["int8"]["out"].float() - chains["exact_convs"]["out"].float()).abs()
    emit({"phase": "tail", "leg": "int8_chain", "batch": BATCH, "size": SIZE, "steps": STEPS, "dtype": "bfloat16",
          "profile": "fast kv_pool=8", **{k: {kk: vv for kk, vv in v.items() if kk != "out"} for k, v in chains.items()},
          "int8_over_exact_ms": chains["int8"]["chain_ms"] / chains["exact_convs"]["chain_ms"],
          "max_abs_diff_vs_exact_convs": float(diff.max())})
    del pipe, chains
    release_memory(torch, "tail int8 chains")
    bad = []
    for c, (want, cpu_s) in zip(convs, plain.result()):
        got = c.pop("got")
        c.update(bitwise_equal=torch.equal(got, want), max_abs_err=float((got.float() - want.float()).abs().max()),
                 plain_cpu_s=cpu_s)
        if not c["bitwise_equal"]:
            bad.append(c)
    emit({"phase": "tail", "leg": "int8_conv", "shapes": len(convs), "convs": convs,
          "int8_ms_a_step": sum(c["int8_ms"] * c["calls_a_step"] for c in convs),
          "exact_bf16_ms_a_step": sum(c["exact_bf16_ms"] * c["calls_a_step"] for c in convs), "ok": not bad})
    if bad:
        raise AssertionError(f"tail: int8_conv on the card differs from its plain version: {bad}")
    tree = read_msgpack(CKPT)
    ref = np.load(CKPT_REF)
    cond, x_T, hr = (torch.from_numpy(ref[k]).cuda() for k in ("cond", "x_T", "hr"))
    psnr = {}
    for name, int8 in (("exact", False), ("int8", True)):
        p = checkpoint_pipeline(torch, tree, 0, torch.float32, conv_int8=int8)
        p.cuda_graph = False  # one chain each: eager, no capture
        out, counts = counted(torch, lambda: p.super_resolve(cond, x_T=x_T, num_steps=STEPS))  # noqa: B023
        if counts != chain_expect(STEPS):
            raise AssertionError(f"tail: checkpoint {name} chain launched {counts}")
        add_counts(totals, counts)
        psnr[name] = psnr_ssim(torch, out, hr)[0]
        del p
    emit({"phase": "tail", "leg": "int8_checkpoint", "checkpoint": CKPT, "dtype": "float32", "steps": STEPS,
          "profile": "exact kv", "psnr_exact": psnr["exact"], "psnr_int8": psnr["int8"],
          "delta_db": [a - b for a, b in zip(psnr["int8"], psnr["exact"])],
          "note": "information: the reference never measured the int8 profile's fidelity"})


def tail_mesh(torch):
    """(c) The five mesh legs (``parallel/dryrun.py::run_legs``) in this process at world size 1 over NCCL, each
    held there to its no-mesh result.  -> the wrappers' counts."""
    import tempfile

    import torch.distributed as dist

    from mrisr_torch.parallel.dryrun import run_legs

    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group("nccl", init_method=f"file://{td}/rendezvous", rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            res, counts = counted(torch, lambda: run_legs("cuda"))
            seconds = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    emit({"phase": "tail", "leg": "mesh", "seconds": seconds, **res, "wrapper_counts": counts, "ok": True})
    return counts


def tail_sdxl(torch):
    """(d) SDXL's two text towers at full width (ViT-L 768 x 12 and bigG 1280 x 32, random weights from fixed
    seeds, fp32) on ``SDXL_PROMPTS`` through ``compute_embeddings_sdxl``, card against CPU."""
    import copy

    from mrisr_torch.models.clip_text import CLIPTextEncoder, HashTokenizer
    from mrisr_torch.models.sdxl_text import CLIPTextEncoderWithProjection, compute_embeddings_sdxl

    torch.manual_seed(70)
    towers = (CLIPTextEncoder(device="cuda"), CLIPTextEncoderWithProjection(device="cuda"))
    cpu = tuple(copy.deepcopy(t).cpu() for t in towers)
    toks = (HashTokenizer(), HashTokenizer())
    out, secs = {}, {}
    for name, tw in (("card", towers), ("cpu", cpu)):
        compute_embeddings_sdxl(tw, toks, SDXL_PROMPTS[:1])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = compute_embeddings_sdxl(tw, toks, SDXL_PROMPTS)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    errs = {}
    for k in ("prompt_embeds", "text_embeds"):
        got, want = out["card"][k].cpu(), out["cpu"][k]
        errs[k] = float((got - want).abs().max() / want.abs().max())
    ok = (max(errs.values()) <= SDXL_TOL and torch.equal(out["card"]["time_ids"].cpu(), out["cpu"]["time_ids"])
          and tuple(out["card"]["prompt_embeds"].shape) == (len(SDXL_PROMPTS), 77, 768 + 1280)
          and tuple(out["card"]["text_embeds"].shape) == (len(SDXL_PROMPTS), 1280))
    rec = {"phase": "tail", "leg": "sdxl_text", "prompts": len(SDXL_PROMPTS), "dtype": "float32", "tf32": False,
           "parameters": [sum(p.numel() for p in t.parameters()) for t in towers], "seconds": secs,
           "max_abs_err_over_max_ref": errs, "tolerance": SDXL_TOL, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"tail: SDXL text towers on the card disagree with the CPU: {rec}")
    del towers, cpu


def phase_tail(torch):
    """The last modules of the port (``tail_eps``, ``tail_chains``, ``tail_train``, ``tail_int8``,
    ``tail_mesh``, ``tail_sdxl``); then B1, the B2 pair and B3 against their plain versions at every (shape,
    dtype) the legs launched them at (``recording_shapes``), and timed at the fused towers' new shapes: B3 at
    2 x 32 groups at each SD width (fp32, bs 8 at 512^2: the fused eps-prediction's heads at the chain's batch;
    B1 and the B2 pair at the fused towers' shapes are timed in phases ``latent`` and ``kernel``,
    ``FLASH_SD`` and ``FLASH_SD_BWD``).  -> the path's launches: the wrappers' counts of eager runs and
    captures, plus the graphs' kernel nodes times the graph launches in traces of their replays (``replayed``,
    the wrappers held at 0 there)."""
    import torch.nn.functional as F

    totals, seconds = {}, {}
    shapes = collections.defaultdict(collections.Counter)

    def leg(name, run):
        t0 = time.perf_counter()
        out, seen = recording_shapes(run)
        seconds[name] = time.perf_counter() - t0
        for wrapper, keys in seen.items():
            shapes[wrapper].update(keys)
        release_memory(torch, f"tail {name}")
        return out

    fused_heads = leg("fused_eps", lambda: tail_eps(torch))
    leg("fused_chains", lambda: tail_chains(torch, totals))
    leg("fused_train", lambda: tail_train(torch, totals))
    leg("int8", lambda: tail_int8(torch, totals))
    add_counts(totals, leg("mesh", lambda: tail_mesh(torch)))
    leg("sdxl", lambda: tail_sdxl(torch))
    t0 = time.perf_counter()
    worst = {"group_norm_silu": 0.0, "flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    for (shape, groups, eps, dtype) in sorted(shapes["group_norm_silu"], key=str):
        rec = check_gn(torch, F, dtype, "tail_head", shape, groups, timed=False, eps=eps)
        worst["group_norm_silu"] = max(worst["group_norm_silu"], rec["err_over_limit"])
    for (b, n, m, d, dtype) in sorted(shapes["flash_attention_fwd"], key=str):
        rec = check_flash(torch, F, dtype, "tail_site", b, n, m, d, timed=False)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], rec["o_err_over_limit"])
    for (b, n, m, d, dtype) in sorted(shapes["flash_attention_bwd"], key=str):
        recs = check_flash_bwd(torch, F, dtype, "tail_site", b, n, m, d, timed=False)
        worst["flash_attention_bwd"] = max([worst["flash_attention_bwd"]] + [
            e["err_over_limit"] for r in recs.values() for e in r["errors"].values()])
    seconds["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain = dict.fromkeys(("ms", "bound_ms", "plain_ms", "library_ms"), 0.0)
    fused_calls = 0
    for (shape, groups, eps, dtype), calls in sorted(fused_heads.items(), key=lambda kv: -math.prod(kv[0][0])):
        if groups != 64:
            continue
        shape = (BATCH, *shape[1:])  # at the 512^2 chain's batch
        rec = check_gn(torch, F, dtype, "sd_fused_head", shape, groups, timed=True, eps=eps, brief=True)
        per_chain = calls * LATENT_STEPS
        fused_calls += per_chain
        emit({"phase": "tail_head", "shape": list(shape), "groups": groups, "dtype": rec["dtype"],
              "calls_a_512_chain": per_chain})
        for k in chain:
            chain[k] += per_chain * rec[k]
    emit({"phase": "tail_head_totals", "dtype": "float32", "calls_a_chain": fused_calls,
          **{f"{k}_a_chain": v for k, v in chain.items()}})
    seconds["timed_checks"] = time.perf_counter() - t0
    checked = {w: sorted([list(k[:-1]) + [str(k[-1]).split(".")[-1]] for k in keys], key=str)
               for w, keys in shapes.items()}
    emit({"phase": "tail", "leg": "summary", "seconds": seconds, "shapes_checked": checked,
          "worst_err_over_limit": worst, "launches": totals})
    return totals


KERNELS = [  # (name, route, source, the TPU kernel it replaces)
    ("flash_attention_fwd", "cuda", "mrisr_torch/csrc/flash_attn_fwd.cu", "mrisr_tpu/ops/flash_attention.py:98"),
    ("flash_attention_bwd_dq", "cuda", "mrisr_torch/csrc/flash_attn_bwd.cu", "mrisr_tpu/ops/flash_attention.py:228"),
    ("flash_attention_bwd_dkv", "cuda", "mrisr_torch/csrc/flash_attn_bwd.cu", "mrisr_tpu/ops/flash_attention.py:262"),
    ("group_norm_silu", "cuda", "mrisr_torch/csrc/group_norm_silu.cu", "mrisr_tpu/ops/groupnorm.py:57"),
]


def summary(recs, path_launches):
    """The kernels line: launches are those of the main paths (``path_launches``: each path's counts, set to 0
    just before it was driven and read just after)."""
    entries = []
    for name, route, source, replaces in KERNELS:
        main = next(r for r in recs[name] if "ms" in r and r["dtype"] == "bfloat16")  # heaviest main-path shape
        by_path = {path: counts.get(name, 0) for path, counts in path_launches.items()}
        entries.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "device_ms": main.get("device_ms"),
            "case": main["case"], "shape": main["shape"],
            "dtype": main["dtype"], "max_abs_err_all_checks": max(r["max_abs_err"] for r in recs[name])})
    return {"kernels": entries}


PHASES = ("kernel", "chain", "checkpoint", "volume", "ddpm", "latent", "latent_train", "prep", "forward", "train",
          "cli", "parity", "tail", "grad", "bench")
# Paths whose launches the kernels line counts; serving paths launch no backward kernel.
MAIN_PATHS = ("chain", "checkpoint", "volume", "ddpm", "latent", "latent_train", "prep", "train", "cli", "parity",
              "tail")


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
    t0 = time.perf_counter()
    phase_build(torch)
    emit({"phase": "seconds", "of": "build", "s": time.perf_counter() - t0})
    recs, path_launches = None, {}
    for name, run in (("kernel", phase_kernels), ("chain", phase_chain), ("checkpoint", phase_checkpoint),
                      ("volume", phase_volume), ("ddpm", phase_ddpm), ("latent", phase_latent),
                      ("latent_train", phase_latent_train), ("prep", phase_prep), ("forward", phase_forward),
                      ("train", phase_train), ("cli", phase_cli), ("parity", phase_parity), ("tail", phase_tail),
                      ("grad", phase_grad),
                      ("bench", phase_bench)):
        if name not in phases:
            continue
        gc.collect()  # an earlier phase's graphs and their memory pools: a capture must not run short
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = run(torch)
        emit({"phase": "seconds", "of": name, "s": time.perf_counter() - t0})
        if name == "kernel":
            recs = out
        elif name in MAIN_PATHS:
            path_launches[name] = out
    if recs and set(path_launches) == set(MAIN_PATHS):
        summary_line = summary(recs, path_launches)
        emit(summary_line)
        unlaunched = [e["name"] for e in summary_line["kernels"] if e["launches"] == 0]
        if unlaunched:
            raise AssertionError(f"kernels the main paths never launched: {unlaunched}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
