"""Check on one GPU what the fp32 flash backward assumes of Hopper's tf32 products.

Run from the repository root: ``python3 -m mrisr_torch.tools.tf32_probe``.
It builds ``tools/tf32_probe.cu`` (the helpers of ``csrc/hopper.cuh``) and
prints one JSON line:

* ``ss``: one wgmma product of raw fp32 operands (128B and 64B swizzled
  tiles), its largest error against the operands read as tf32 three ways --
  the 13 low mantissa bits dropped (``drop``), rounded to nearest even
  (``rne``) and half away from zero (``rna``) -- over the largest result.
  The model that matches to fp32 rounding is what the tensor cores do
  (``flash_attention.TF32_MASK``: ``drop``);
* ``rs``: a product with A from an accumulator-layout register tile
  (``to_tf32_frags``) and B from the transposed, permuted copies
  (``flash_attention.transpose_permuted`` of the ``tf32_hi``, ``tf32_lo``
  split), in 3xTF32 and in 1xTF32, each error over the largest exact result;
* ``ok``: the tensor cores drop the bits, and 3xTF32 is fp32-accurate
  through the permuted layout.

Last it prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mrisr_torch import _build
from mrisr_torch.ops import flash_attention as fa
from mrisr_torch.tools.flash_fwd_sweep import card

SOURCE = Path(__file__).resolve().parent / "tf32_probe.cu"


def build() -> ctypes.CDLL:
    out = _build.BUILD_ROOT / "tf32_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtf32_probe.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stderr[-4000:]}")
    so = ctypes.CDLL(str(lib))
    so.tf32_probe_ss.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    so.tf32_probe_rs.argtypes = [ctypes.c_void_p] * 6
    return so


def as_tf32(x: np.ndarray, mode: str) -> np.ndarray:
    """fp32 ``x`` read as tf32 (10 mantissa bits) by ``mode``, as float64."""
    bits = x.astype(np.float32).view(np.int32).astype(np.int64)
    if mode == "rne":
        bits = bits + 0xFFF + ((bits >> 13) & 1)
    elif mode == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).astype(np.int32).view(np.float32).astype(np.float64)


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lib = build()
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"ss": {}}
    for k in (32, 16):
        # Values over a few octaves, so that every low mantissa bit is exercised.
        a = (rng.standard_normal((64, k)) * 2.0 ** rng.integers(-3, 4, (64, k))).astype(np.float32)
        b = (rng.standard_normal((32, k)) * 2.0 ** rng.integers(-3, 4, (32, k))).astype(np.float32)
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        d = torch.empty((64, 32), device="cuda")
        if lib.tf32_probe_ss(ta.data_ptr(), tb.data_ptr(), d.data_ptr(), k, stream) != 0:
            raise RuntimeError("tf32_probe_ss failed to launch")
        got = d.cpu().numpy().astype(np.float64)
        errs = {}
        for mode in ("drop", "rne", "rna"):
            want = as_tf32(a, mode) @ as_tf32(b, mode).T
            errs[mode] = float(np.abs(got - want).max() / np.abs(want).max())
        rec["ss"][f"k{k}"] = errs
    x = rng.standard_normal((64, 32)).astype(np.float32)
    y = rng.standard_normal((32, 64)).astype(np.float32)
    ty = torch.from_numpy(y)[None]
    yt = fa.transpose_permuted(fa.tf32_hi(ty), pad=8)[0].contiguous().cuda()
    yt_lo = fa.transpose_permuted(fa.tf32_lo(ty), pad=8)[0].contiguous().cuda()
    tx = torch.from_numpy(x).cuda()
    c3, c1 = torch.empty((64, 64), device="cuda"), torch.empty((64, 64), device="cuda")
    if lib.tf32_probe_rs(tx.data_ptr(), yt.data_ptr(), yt_lo.data_ptr(), c3.data_ptr(), c1.data_ptr(), stream) != 0:
        raise RuntimeError("tf32_probe_rs failed to launch")
    exact = x.astype(np.float64) @ y.astype(np.float64)
    scale = np.abs(exact).max()
    rec["rs"] = {"3xtf32_rel_err": float(np.abs(c3.cpu().numpy() - exact).max() / scale),
                 "1xtf32_rel_err": float(np.abs(c1.cpu().numpy() - exact).max() / scale)}
    modes = [min(errs, key=errs.get) for errs in rec["ss"].values()]
    rec["mode"] = modes[0] if len(set(modes)) == 1 else modes
    rec["ok"] = (rec["mode"] == "drop" and all(e["drop"] < 1e-6 for e in rec["ss"].values())
                 and rec["rs"]["3xtf32_rel_err"] < 1e-5 < rec["rs"]["1xtf32_rel_err"])
    print(json.dumps(rec), flush=True)
    print(card(), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
