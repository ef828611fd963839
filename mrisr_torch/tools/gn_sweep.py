"""Time design variants of GroupNorm+SiLU (``csrc/group_norm_silu.cu``) on one GPU.

Run from the repository root: ``python3 -m mrisr_torch.tools.gn_sweep``.  As ``flash_fwd_sweep``: each
variant is the checked-in source with a few lines replaced (or the plan cut with another slice target),
all are built at once under ``mrisr_torch/.build/sweep/group_norm_silu/``, each is checked against the
plain version and then its device time is read from ``torch.profiler`` (``chip_smoke.device_ms``: at the
small heads a loop of launches timed with CUDA events would time the host) in turns (every variant, then
every variant again in reverse order) at the UNet's 13 head shapes, in bf16 and fp32.  One JSON line per shape, then the
card's name and power limit.

Variants, each an alternative to one choice of the design (512 threads a CTA, 4 predicated 16-byte
loads in flight a thread, registers capped for 3 CTAs an SM, slices of up to 64 KB):

* ``batch2_occ4``: 2 loads a thread, registers capped for 4 CTAs an SM;
* ``batch4_occ2``: registers capped for 2 CTAs an SM;
* ``batch8``: 8 loads a thread, registers not capped;
* ``threads256``: 256 threads a CTA (registers capped for 6 CTAs an SM);
* ``target32k`` / ``target128k``: the plan aims at slices of 32 / 128 KB (more, smaller CTAs a span /
  fewer, larger ones).

ptxas's spills and notes are printed for each variant (a variant that spills is still timed).
"""
from __future__ import annotations

import json
import sys

import torch

from mrisr_torch.ops import groupnorm as gn
from mrisr_torch.tools.flash_fwd_sweep import build_variants, card
from mrisr_torch.tools.tree_timings import BATCH, GN_SHAPES

_BATCH, _OCC = "constexpr int kBatch = 4;", "constexpr int kMinBlocks = 3;"
VARIANTS = {
    "design": [],
    "batch2_occ4": [(_BATCH, "constexpr int kBatch = 2;"), (_OCC, "constexpr int kMinBlocks = 4;")],
    "batch4_occ2": [(_OCC, "constexpr int kMinBlocks = 2;")],
    "batch8": [(_BATCH, "constexpr int kBatch = 8;"), (_OCC, "constexpr int kMinBlocks = 1;")],
    "threads256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                   (_OCC, "constexpr int kMinBlocks = 6;")],
}
TARGETS = {"target32k": 32 * 1024, "target128k": 128 * 1024}  # the design source, another plan


def sweep_shape(smoke, fns: dict, c: int, hw: int, dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(c + hw)
    x = (torch.randn((BATCH, c, hw, hw), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    y = torch.empty_like(x)
    want = gn.group_norm_silu_plain(x, w, b, 16, 1e-5).float()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, (fn, target) in fns.items():
        p = gn.gn_plan((BATCH, c, hw, hw), 16, x.element_size(), target)
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), BATCH * 16, p.span, hw * hw, c // 16, 16,
                gn.GN_DTYPES[dtype], p.cluster, p.chunk, int(p.resident), int(p.vec), 1e-5, stream)
        calls[name] = lambda fn=fn, args=args: fn(*args)
    rec = {"shape": [BATCH, c, hw, hw], "dtype": str(dtype).split(".")[-1], "max_abs_err": {},
           "ms": {name: [] for name in calls}}
    for name, call in calls.items():
        if call() != 0:
            raise RuntimeError(f"variant {name} failed to launch")
        torch.cuda.synchronize()
        rec["max_abs_err"][name] = float((y.float() - want).abs().max())
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            rec["ms"][name].append(smoke.device_ms(torch, calls[name], None))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("gn_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as smoke

    fns = {}
    for name, lib in build_variants(VARIANTS, "group_norm_silu").items():
        fn = lib.mrisr_group_norm_silu
        fn.argtypes, fn.restype = gn._ARGTYPES, gn.ctypes.c_int
        fns[name] = (fn, gn.GN_SLICE_TARGET)
    for name, target in TARGETS.items():
        fns[name] = (fns["design"][0], target)
    for dtype in (torch.bfloat16, torch.float32):
        for c, hw in GN_SHAPES:
            print(json.dumps(sweep_shape(smoke, fns, c, hw, dtype)), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
