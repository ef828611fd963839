"""Time design variants of the flash-attention backward (``csrc/flash_attn_bwd.cu``) on one GPU.

Run from the repository root: ``python3 -m mrisr_torch.tools.flash_bwd_sweep``
(``--variants`` and ``--d`` as in ``flash_fwd_sweep``).
As ``flash_fwd_sweep``: each variant is the checked-in source with a few
lines replaced, all are built at once (under
``mrisr_torch/.build/sweep/flash_attn_bwd/``), each variant's dQ and dK/dV
are checked against the plain version and then timed with CUDA events in
turns (every variant, then every variant again in reverse order) on the
training path's shapes and two more, in bf16 (the variants without a prefix)
and in fp32 (``f32_*``; the fp32 kernels' 3xTF32 operands are made once per
shape).  It prints one JSON line per shape and, last, the card's name and
power limit.

bf16 variants, each an alternative to one choice of the design:

* ``design``: the source as it is (both kernels: the consumers take turns;
  dQ: 128 keys a tile, 64 at D=128; dK/dV: 64 queries a tile, 32 at D=128);
* ``no_pingpong``: no turns in either kernel;
* ``dkv_bq128_d32`` / ``dkv_bq64_d128``: dK/dV walks 128 queries a tile at
  D=32 / 64 at D=128;
* ``dq_bk64`` / ``dq_bk128_d128``: dQ walks 64 keys a tile at every D /
  128 at D=128;
* ``dq_mask_in_loop``: dQ's last tile inside the loop (its key mask then
  runs, as selects, on every tile);
* ablations, timed only (their results are wrong): ``ablate_dq_exp`` and
  ``ablate_dkv_exp`` drop the exponentials (the FFMA before each stays),
  ``ablate_dkv_second`` drops dK/dV's second-stage products (dV, dK).

fp32 (3xTF32) variants:

* ``f32_no_pingpong``: no turns in either kernel;
* ``f32_dq_bk32_d32``: dQ walks 32 keys a tile at D=32 (design 64);
* ``f32_dkv_bq64_d32``: dK/dV walks 64 queries a tile at D=32, in 2 stages
  (design 32 in 4);
* ``f32_dkv_one_consumer_d64``: dK/dV at D=64 with one consumer warpgroup
  (64 K/V rows a CTA), 32 queries a tile in 2 stages (design: two consumers,
  16 queries in 3 stages);
* ``f32_dq_two_consumers_d64``: dQ at D=64 with two consumers (128 Q rows
  a CTA) and 32 keys in 2 stages (design: one consumer, 3 stages);
* dQ at D=40 (design: one consumer, 64 keys a tile in 3 stages), with two
  consumers (128 Q rows a CTA): ``f32_dq_two_consumers_d40`` 64 keys in 2
  stages, ``f32_dq_two_consumers_bk32_d40`` 32 keys in 3,
  ``f32_dq_two_consumers_bk32_s4_d40`` 32 keys in 4;
* ``f32_dkv_stages2_d40``: dK/dV at D=40 in 2 stages (design: 32 queries in
  3; 16 queries would leave the D-wide tiles off their 1024-byte alignment);
* ``f32_dkv_one_consumer_d40``: dK/dV at D=40 with one consumer (64 K/V rows
  a CTA), 32 queries in 4 stages;
* ablations, timed only: ``f32_ablate_1xtf32`` (only the hi·hi product of
  each 3xTF32 triple), ``f32_ablate_exp`` (no exponentials, in both
  kernels), ``f32_ablate_second`` (no dQ, dV, dK products).
"""
from __future__ import annotations

import json
import math
import sys

import torch

from mrisr_torch.ops import flash_attention as fa
from mrisr_torch.tools.flash_fwd_sweep import build_variants, card, entry, parse_args

SHAPES = [(8, 16384, 16384, 32), (8, 4096, 4096, 64), (8, 4096, 4096, 128), (8, 16384, 256, 32)]
# The fp32 shapes: the ResDiff sites, and the SD route's 1024^2 training step (16 and 8 heads x lanes).
SHAPES_F32 = [(8, 16384, 16384, 32), (8, 4096, 4096, 64), (2, 1024, 1024, 128), (16, 16384, 16384, 40),
              (8, 16384, 16384, 40)]

_TURNS = ("kPingPong = true;", "kPingPong = false;")
_DKV_SECOND = """wgmma_rs<D>(dv_acc, pt[kk], T::mn_major(do_s + st * T::kTileBytes, BQ, kk));
        wgmma_rs<D>(dk_acc, dst[kk], T::mn_major(q_s + st * T::kTileBytes, BQ, kk));"""
VARIANTS = {
    "design": [],
    "no_pingpong": [_TURNS, _TURNS],  # the first occurrence is dQ's, then dK/dV's
    "dkv_bq128_d32": [("kQueries = D == 128 ? 32 : 64;", "kQueries = D == 128 ? 32 : (D == 32 ? 128 : 64);")],
    "dkv_bq64_d128": [("kQueries = D == 128 ? 32 : 64;", "kQueries = 64;")],
    "dq_bk64": [("kKeys = D == 128 ? 64 : 128;", "kKeys = 64;")],
    "dq_bk128_d128": [("kKeys = D == 128 ? 64 : 128;", "kKeys = 128;")],
    "dq_mask_in_loop": [("for (int t = 1; t < n_tiles - 1; ++t) step(t, false); if (n_tiles > 1) step(n_tiles - 1, ragged);",
                         "for (int t = 1; t < n_tiles; ++t) step(t, ragged && t == n_tiles - 1);")],
    # Ablations, for where the time goes (wrong results: timed only).
    "ablate_dq_exp": [("ex2(fmaf(s[4 * j", "(fmaf(s[4 * j")] * 4,  # the four scores of an n-block
    "ablate_dkv_exp": [("p = ex2(fmaf(st_acc[4 * j + e]", "p = (fmaf(st_acc[4 * j + e]")],
    "ablate_dkv_second": [(_DKV_SECOND, "")],
}
_F32_DKV_TILES = ("kQueries = D <= 40 ? 32 : 16;", "kStages = D == 32 ? 4 : (D <= 64 ? 3 : 1);")
_F32_TURNS = ("kPingPong = kConsumers == 2;", "kPingPong = false;")
_F32_DQ_TILES = ("kConsumers = D == 32 ? 2 : 1;", "kKeys = D <= 40 ? 64 : (D == 64 ? 32 : 16);",
                 "kStages = D == 128 ? 2 : 3;")
_3X_SS = """wgmma_tf32_ss<N>(d, a_lo, b_hi, scale_d);
  wgmma_tf32_ss<N>(d, a_hi, b_lo, 1);
  wgmma_tf32_ss<N>(d, a_hi, b_hi, 1);"""
_3X_RS = """wgmma_tf32_rs<N>(d, a_lo, b_hi, scale_d);
  wgmma_tf32_rs<N>(d, a_hi, b_lo);
  wgmma_tf32_rs<N>(d, a_hi, b_hi);"""
VARIANTS.update({
    "f32_no_pingpong": [_F32_TURNS, _F32_TURNS],
    "f32_dq_bk32_d32": [(_F32_DQ_TILES[1], "kKeys = D == 40 ? 64 : (D <= 64 ? 32 : 16);")],
    "f32_dkv_bq64_d32": [(_F32_DKV_TILES[0], "kQueries = D == 32 ? 64 : (D == 40 ? 32 : 16);"),
                         (_F32_DKV_TILES[1], "kStages = D == 32 ? 2 : (D <= 64 ? 3 : 1);")],
    "f32_dkv_one_consumer_d64": [
        ("kConsumers = 2; // At D=128 the owned tiles", "kConsumers = D == 64 ? 1 : 2; // At D=128 the owned tiles"),
        (_F32_DKV_TILES[0], "kQueries = D == 128 ? 16 : 32;"),
        (_F32_DKV_TILES[1], "kStages = D == 32 ? 4 : (D == 40 ? 3 : (D == 64 ? 2 : 1));")],
    "f32_dkv_stages2_d40": [(_F32_DKV_TILES[1], "kStages = D == 32 ? 4 : (D == 40 ? 2 : (D == 64 ? 3 : 1));")],
    "f32_dkv_one_consumer_d40": [
        ("kConsumers = 2; // At D=128 the owned tiles", "kConsumers = D == 40 ? 1 : 2; // At D=128 the owned tiles"),
        (_F32_DKV_TILES[1], "kStages = D <= 40 ? 4 : (D == 64 ? 3 : 1);")],
    "f32_dq_two_consumers_d64": [(_F32_DQ_TILES[0], "kConsumers = D == 32 || D == 64 ? 2 : 1;"),
                                 (_F32_DQ_TILES[2], "kStages = D == 64 || D == 128 ? 2 : 3;")],
    "f32_dq_two_consumers_d40": [(_F32_DQ_TILES[0], "kConsumers = D <= 40 ? 2 : 1;"),
                                 (_F32_DQ_TILES[2], "kStages = D == 40 || D == 128 ? 2 : 3;")],
    "f32_dq_two_consumers_bk32_d40": [(_F32_DQ_TILES[0], "kConsumers = D <= 40 ? 2 : 1;"),
                                      (_F32_DQ_TILES[1], "kKeys = D == 32 ? 64 : (D <= 64 ? 32 : 16);")],
    "f32_dq_two_consumers_bk32_s4_d40": [(_F32_DQ_TILES[0], "kConsumers = D <= 40 ? 2 : 1;"),
                                         (_F32_DQ_TILES[1], "kKeys = D == 32 ? 64 : (D <= 64 ? 32 : 16);"),
                                         (_F32_DQ_TILES[2], "kStages = D == 40 ? 4 : (D == 128 ? 2 : 3);")],
    # Ablations, timed only.
    "f32_ablate_1xtf32": [("hopper.cuh", _3X_SS, "wgmma_tf32_ss<N>(d, a_hi, b_hi, scale_d);"),
                          ("hopper.cuh", _3X_RS, "wgmma_tf32_rs<N>(d, a_hi, b_hi, scale_d);")],
    # the first four anchors are bf16 dQ's (not timed here), the next four fp32 dQ's; then dK/dV's
    "f32_ablate_exp": [("ex2(fmaf(s[4 * j", "(fmaf(s[4 * j")] * 8
                      + [("p = ex2(fmaf(st_acc[4 * j + e]", "p = (fmaf(st_acc[4 * j + e]")] * 2,
    "f32_ablate_second": [
        ("""wgmma_3xtf32_rs<D>(dq_part, ds_hi[kk], ds_lo[kk], RT::k_major(kt, D, 0, kk),
                           RT::k_major(kt + T::kTileBytes, D, 0, kk), kk > 0);""", ""),
        ("""wgmma_3xtf32_rs<DC>(dv_part, pt_hi[kk], pt_lo[kk], walked_t(6, kk), walked_t(7, kk), kk > 0);
        wgmma_3xtf32_rs<DC>(dk_part, ds_hi[kk], ds_lo[kk], walked_t(4, kk), walked_t(5, kk), kk > 0);""", "")],
})


def sweep_shape(fns: dict, b: int, n: int, m: int, d: int, dtype=torch.bfloat16, iters: int = 20) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(b + n + m + d)
    q, k, v, do = (torch.randn((b, s, d), generator=gen, device="cuda").to(dtype) for s in (n, m, m, n))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(dim=-1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    bf16 = int(dtype == torch.bfloat16)
    parts = None if bf16 else fa.tf32_parts(q, k, v, do)
    ptrs = None if bf16 else fa._parts_arg(q, k, v, do, parts)[0]
    dq = torch.empty_like(q)
    calls = {}
    for name, (fn_dq, fn_dkv) in fns.items():
        calls[f"{name}/dq"] = lambda fn=fn_dq: fn(*args, dq.data_ptr(), b, n, m, d, bf16, scale, ptrs, stream)
        calls[f"{name}/dkv"] = lambda fn=fn_dkv: fn(*args, dk.data_ptr(), dv.data_ptr(), b, n, m, d, bf16, scale,
                                                     ptrs, stream)
    rec = {"shape": [b, n, m, d], "dtype": str(dtype).split(".")[-1], "max_abs_err": {},
           "ms": {key: [] for key in calls}}
    for key, call in calls.items():
        if call() != 0:
            raise RuntimeError(f"{key} failed to launch")
        torch.cuda.synchronize()
        got = (dq,) if key.endswith("/dq") else (dk, dv)
        ref = want[:1] if key.endswith("/dq") else want[1:]
        rec["max_abs_err"][key] = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, ref))
    for call in calls.values():  # every variant warm, so the first timed slot is not the card's ramp-up
        for _ in range(5):
            call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for order in (list(calls), list(reversed(calls))):
        for key in order:
            for _ in range(3):
                calls[key]()
            start.record()
            for _ in range(iters):
                calls[key]()
            end.record()
            end.synchronize()
            rec["ms"][key].append(start.elapsed_time(end) / iters)
    return rec


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    keep, timed = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    libs = build_variants({name: edits for name, edits in VARIANTS.items() if keep(name)}, "flash_attn_bwd")
    fns = {name: (entry(lib, "mrisr_flash_attn_bwd_dq"), entry(lib, "mrisr_flash_attn_bwd_dkv"))
           for name, lib in libs.items()}
    bf16 = {k: f for k, f in fns.items() if not k.startswith("f32_")}
    f32 = {k: f for k, f in fns.items() if k == "design" or k.startswith("f32_")}
    for shape in filter(timed, SHAPES):
        if len(bf16) > 1:
            print(json.dumps(sweep_shape(bf16, *shape)), flush=True)
    for shape in filter(timed, SHAPES_F32):
        if len(f32) > 1:
            print(json.dumps(sweep_shape(f32, *shape, dtype=torch.float32)), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
