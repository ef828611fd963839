"""Time GroupNorm+SiLU (B3) at the UNet's 13 head shapes, the fp32 flash forward (B1) at the chain's two
flash sites, and one traced training step per policy, with the package of the tree it runs in.

Run from the root of a tree: ``python3 -m mrisr_torch.tools.tree_timings``.  It imports that tree's
``mrisr_torch`` and ``chip_smoke.py`` (its timing helpers: CUDA events, ``torch.profiler`` windows, host
time per call, ``profile_step``), so two trees -- one an earlier commit unpacked with ``git archive`` --
are compared on one card by running it in each, in turns, within one command.  One JSON line per
measurement, then the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

BATCH = 8
# (C, H = W) of the UNet's 29 ConvBlock heads at 256^2, with how many of them a UNet call runs.
GN_SHAPES = {(32, 256): 5, (64, 256): 1, (96, 256): 1, (32, 128): 1, (64, 128): 3, (96, 128): 1, (192, 128): 1,
             (64, 64): 1, (128, 64): 3, (192, 64): 1, (256, 64): 1, (128, 32): 8, (256, 32): 2}
FLASH_SITES = [(BATCH, 16384, 16384, 32), (BATCH, 4096, 4096, 64)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_gn(smoke, gn) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        for (c, hw), per_call in GN_SHAPES.items():
            gen = torch.Generator(device="cuda").manual_seed(c + hw)
            x = (torch.randn((BATCH, c, hw, hw), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            run = lambda: gn.group_norm_silu(x, w, b, 16, 1e-5)  # noqa: E731
            err = float((run().float() - gn.group_norm_silu_plain(x, w, b, 16, 1e-5).float()).abs().max())
            emit({"kernel": "group_norm_silu", "dtype": str(dtype).split(".")[-1], "shape": [BATCH, c, hw, hw],
                  "per_unet_call": per_call, "max_abs_err": err, "ms": smoke.cuda_ms(torch, run),
                  "device_ms": smoke.device_ms(torch, run, None), "host_us": smoke.host_us(torch, run)})


def time_flash_f32(smoke, fa) -> None:
    for b, n, m, d in FLASH_SITES:
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        q, k, v = (torch.randn((b, s, d), generator=gen, device="cuda") for s in (n, m, m))
        scale = 1.0 / math.sqrt(d)
        run = lambda: fa.flash_attention_fwd(q, k, v, scale)  # noqa: E731
        # Few calls for the host time: the fp32 operand prep is some 20 launches a call, and the launch
        # queue must not fill (the enqueue would then wait for the device).
        emit({"kernel": "flash_attention_fwd", "dtype": "float32", "shape": [b, n, m, d],
              "ms": smoke.cuda_ms(torch, run), "kernel_device_ms": smoke.device_ms(torch, run, "flash_fwd_"),
              "device_ms": smoke.device_ms(torch, run, None), "host_us": smoke.host_us(torch, run, iters=20)})


def main() -> int:
    if not torch.cuda.is_available():
        print("tree_timings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as smoke

    from mrisr_torch.diffusion.schedules import resdiff_schedule
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.ops import build_kernels
    from mrisr_torch.ops import flash_attention as fa
    from mrisr_torch.ops import groupnorm as gn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels()
    time_gn(smoke, gn)
    time_flash_f32(smoke, fa)
    torch.manual_seed(4)
    unet = ResDiffUNet(image_size=256)
    batch = smoke._synthetic_batch(torch, BATCH, 256, 5, "cuda")
    for precision in ("bfloat16", "float32"):
        smoke.profile_step(torch, unet, resdiff_schedule(1000), batch, precision)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
