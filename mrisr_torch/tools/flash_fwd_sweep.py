"""Time design variants of the flash-attention forward (``csrc/flash_attn_fwd.cu``) on one GPU.

Run from the repository root: ``python3 -m mrisr_torch.tools.flash_fwd_sweep``
(``--variants 'f32_*d40'`` and ``--d 40`` narrow it to some variants, the
design always among them, and to the shapes of some head widths).
Each variant is the checked-in source with a few lines replaced; all are
built at once with ``nvcc`` (the flags of ``mrisr_torch/_build.py``) under
``mrisr_torch/.build/sweep/flash_attn_fwd/`` and timed with CUDA events in turns (every
variant, then every variant again in reverse order) on the chain's shapes,
after its output is checked against the plain version, in bf16 (the
variants without a prefix) and in fp32 (``f32_*``; the 3xTF32 operands made
once per shape).  Each bf16 variant runs in the form ``ops.flash_attention.fwd_form``
gives, unless ``VARIANT_FORMS`` names one (a variant is skipped at a shape its
form does not take).  It prints one JSON line per shape and, last, the card's
name and power limit.

bf16 variants:

* ``design``: the source as it is;
* ablations of the design in the tiled form, timed
  only (``TIMING_ONLY``: their results are wrong, so their errors are not
  taken): ``ablate_ex2_fmul`` (each score's exponential one FMUL),
  ``ablate_no_rescale`` (O and l never rescaled), ``ablate_no_pack`` (P's
  bf16 pairs by one byte permute of the high halves, truncated, instead of
  the rounding F2FP pack), ``ablate_no_row_max`` (a fixed max of 0, no max
  tree or shuffles), ``ablate_no_l_product`` / ``ablate_no_pv_product`` /
  ``ablate_no_qk_product`` (no denominator: no ones beside V and no wgmma
  against ones / no wgmma for O += P V / for S = Q K^T);
* ``polyN`` (N = 3, 4, 5, 8): N of the 16 column blocks of a score tile
  take their exponentials on the FMA pipes (``exp2_fma``, added to the
  source by the variant: Cody-Waite reduction and a degree-3 minimax
  polynomial, relative error at most 1.02e-4) at every D (the design: none);
* ``rescale_vote`` / ``rescale_slack8``: the row maxima move, and O and l are
  rescaled, only when a row max of the warp grew at all / by more than 8
  (FlashAttention-4's rule; a warp vote, so every lane agrees) at every D
  (the design: after every tile);
* ``form_tiled`` / ``form_resident``: the design in the tiled / resident
  form at every shape either takes (the shapes with M = 512 and 1024 at D=32
  bound ``RESIDENT_MAX_KEYS``; the resident form takes D=32 only);
* ``ones_in_v_none`` / ``ones_in_v_d64``: the denominator by a second wgmma
  at N = 8 against one tile of ones at every D / at D=32 (the design: from a
  tile of ones beside each V tile, one wgmma at N = D + 8 as the
  reference's V_AUG, at D=32 and 64);
* ``fill_old``: the ones filled with 4-byte stores into every stage of the
  ring (the design: 16-byte stores into the stages the loop uses), and
  ``ones_in_v_d64_fill_old`` with ``ones_in_v_d64`` (the design before);
* ``rows64``: CTAs of 64 Q rows with one consumer warpgroup, two CTAs an SM
  (232 registers a consumer thread), at D <= 64 (both forms; the resident
  form's grid two CTAs an SM where shared memory holds them); three CTAs an
  SM (136 registers) do not assemble;
* ``pingpong_all`` / ``pingpong_none``: the two consumer warpgroups take
  turns on named barriers at every D / at none (the design: D=128);
* ``issue_ahead_d32`` / ``issue_ahead_none``: S(t+1) issued before the
  softmax of tile t into a second S buffer at D=32 too / at no D (the
  design: D=64);
* ``consumers3_d32``: three consumer warpgroups (192 Q rows a CTA, 160
  registers a consumer thread) at D=32;
* ``keys256_d32``: BK = 256 keys per tile at D=32 (wgmma m64n256k16 for S);
* ``l_in_registers``: the softmax denominator summed in registers from the
  bf16-rounded p (unpack and add, then a quad reduction) instead of the
  wgmma against a tile of ones (tiled form only);
* ``row_max_serial``: the row max as one dependent chain per row instead of
  four.

The shape list also holds 8x4224x4096x64: 264 CTAs of 128 Q rows, two full
waves on 132 SMs, beside the chain's 8x4096 (256 CTAs), to show what the
partly empty second wave costs at D=64.

fp32 (3xTF32) variants, each an alternative to one choice of the design
(two consumers and 64 keys a tile at D=32, in 4 stages, and at D=40, in 3;
one consumer and 64 keys at D=64, one and 32 at D=128; turns where there
are two consumers):

* ``f32_no_pingpong``: no turns;
* ``f32_one_consumer_d32``: one consumer warpgroup (64 Q rows a CTA) at D=32;
* ``f32_keys32_d32``: 32 keys a tile at D=32;
* ``f32_two_consumers_d64``: two consumers (128 Q rows a CTA) and 32 keys a
  tile at D=64;
* ``f32_keys32_d64``: 32 keys a tile at D=64 (one consumer, 4 stages);
* ``f32_one_consumer_d40``: one consumer warpgroup at D=40;
* ``f32_stages4_d40`` / ``f32_stages2_d40``: 4 / 2 stages at D=40;
* ``f32_keys32_d40``: 32 keys a tile at D=40;
* ablations, timed only (``TIMING_ONLY``; their results are wrong):
  ``f32_ablate_1xtf32`` (only the hi hi product of each 3xTF32 triple),
  ``f32_ablate_exp`` (no exponentials).
"""
from __future__ import annotations

import argparse
import ctypes
import fnmatch
import json
import math
import re
import shutil
import subprocess
import sys

import torch

from mrisr_torch import _build
from mrisr_torch.ops import flash_attention as fa

SHAPES = [(8, 16384, 16384, 32), (8, 4096, 4096, 64), (8, 4224, 4096, 64), (8, 16384, 256, 32),
          (8, 4096, 64, 64), (8, 4096, 4096, 128), (8, 16384, 512, 32), (8, 16384, 1024, 32), (8, 4096, 256, 64),
          (8, 4096, 512, 64)]
# The fp32 shapes: the ResDiff sites, and the SD route's fused 1024^2 chain (32 and 16 heads x images).
SHAPES_F32 = [(8, 16384, 16384, 32), (8, 4096, 4096, 64), (2, 1024, 1024, 128), (32, 16384, 16384, 40),
              (16, 16384, 16384, 40)]

_ONES = "    if constexpr (!T::kOnesInV) wgmma_rs<8>(l, p[kk], make_desc(ones, 128, 256, 0));\n"
# l += the row sums of the bf16 p of k-step kk, in registers (this thread's columns; reduced in the epilogue).
_REGSUM = """#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u = p[kk][2 * h], w = p[kk][2 * h + 1];
      l[0] += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
      l[2] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
    }
"""
_L_EPILOGUE = "  const float l0 = T::kOnesInV ? o_acc[D / 2] : l_acc[0], l1 = T::kOnesInV ? o_acc[D / 2 + 2] : l_acc[2];\n"
_RESCALE = "__device__ __forceinline__ void rescale(float (&o)[T::kAccN / 2], float (&l)[4], float a0, float a1) {"
_MAX_TREE_BLOCK = """  float c0[4], c1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] = fmaxf(s[4 * i], s[4 * i + 1]);
    c1[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int j = 4; j < BK / 8; ++j) {
    c0[j % 4] = fmaxf(c0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
    c1[j % 4] = fmaxf(c1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx0 = fmaxf(fmaxf(c0[0], c0[1]), fmaxf(c0[2], c0[3]));
  float mx1 = fmaxf(fmaxf(c1[0], c1[1]), fmaxf(c1[2], c1[3]));
"""
# The exponentials of a bf16 score tile (softmax_tile), and the head of that function.
_EXP = """    s[4 * j] = ex2(fmaf(s[4 * j], sl2, -m0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -m0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -m1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -m1));"""
_SOFTMAX_HEAD = "template <int BK>\n__device__ __forceinline__ void softmax_tile("
# 2^x on the FMA pipes, put before softmax_tile by the polyN variants.
_EXP2_FMA = """// 2^x on the FMA pipes, for the share of a tile's exponentials that the
// special-function units (16 a clock per SM, against 128 FMA lanes) do not
// take.  Cody-Waite: x = j + f with j = round(x) (the 1.5 * 2^23 shift puts j
// in t's low mantissa bits) and f in [-0.5, 0.5]; 2^f by a degree-3 minimax
// polynomial (relative error at most 1.02e-4, about 2^-13.3, in fp32 Horner
// form; p is then rounded to bf16 at 2^-9); j is added to the exponent bits.
// x <= -127 and -inf (masked keys) give +0 (or a denormal below 2^-126): the
// polynomial is 1 at 0 and >= 1 on [0, 0.5], so the exponent never wraps.
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.0550089292f, f, 0.242210954f), f, 0.693282902f), f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

"""
# The row maxima's move in softmax_tile (the first match: the fp32 softmax has the same lines further on).
_MAX_MOVE = """  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;"""


def _poly(n: int) -> list:
    """Column block j of the 16 of a score tile on ``exp2_fma`` when it holds one of n evenly spread steps."""
    fma = _EXP.replace("ex2(", "exp2_fma(")
    return [(_SOFTMAX_HEAD, _EXP2_FMA + _SOFTMAX_HEAD),
            (_EXP, f"if ((j * {n}) / (BK / 8) != ((j + 1) * {n}) / (BK / 8)) {{\n{fma}\n    }} else {{\n{_EXP}\n    }}")]


def _rescale_vote(slack: int) -> list:
    """The maxima move only when one of the warp's rows grew by more than ``slack`` (log2 units; p then stays
    below 2^slack), and the rescale is skipped when no factor of the warp differs from 1."""
    return [(_MAX_MOVE, f"""if (__any_sync(0xffffffffu, n0 > m0 + {slack}.f || n1 > m1 + {slack}.f)) {{
{_MAX_MOVE}
  }} else {{
    a0 = a1 = 1.f;
  }}"""),
            (_RESCALE, _RESCALE + "\n  if (__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) return;")]


_BOUNDS = "__launch_bounds__(Bf16Tiles<D>::kThreads, 1)"
# The ones filled with 4-byte stores into every stage of the ring (the design: 16-byte stores, the stages used).
_FILL_OLD = [("""  const uint4 one = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  if constexpr (T::kOnesInV) {
    for (int t = 0; t < tiles; ++t) {
      uint4* w = reinterpret_cast<uint4*>(smem + v + t * T::kVStageBytes + T::kTileBytes);
      for (int i = threadIdx.x; i < T::kTileBytes / 16; i += T::kThreads) w[i] = one;
    }
  } else {
    uint4* w = reinterpret_cast<uint4*>(smem + ones);
    for (int i = threadIdx.x; i < T::kOnesBytes / 16; i += T::kThreads) w[i] = one;
  }""", """  if constexpr (T::kOnesInV) {
    for (int t = 0; t < tiles; ++t) {
      uint32_t* w = reinterpret_cast<uint32_t*>(smem + v + t * T::kVStageBytes + T::kTileBytes);
      for (int i = threadIdx.x; i < T::kTileBytes / 4; i += T::kThreads) w[i] = 0x3F803F80u;
    }
  } else {
    uint32_t* w = reinterpret_cast<uint32_t*>(smem + ones);
    for (int i = threadIdx.x; i < T::kOnesBytes / 4; i += T::kThreads) w[i] = 0x3F803F80u;
  }"""), ("fill_ones<T>(smem, ones_s - base, v_s - base, n_tiles < S ? n_tiles : S);",
          "fill_ones<T>(smem, ones_s - base, v_s - base, S);")]
_RESIDENT_GRID = "const int grid = items < sms ? (int)items : sms;"
_PACK = """p[kk][2 * h] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[kk][2 * h + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);"""
_MAX_SHUFFLES = """  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
"""
_CONSUMERS = "static constexpr int kConsumers = 2;"
_PV = "    wgmma_rs<T::kAccN>(o, p[kk], T::mn_major(v, BK, kk));\n"
_QK = """        wgmma_ss<BK>(s, T::k_major(q_s, T::kRowsQ, wg * 64, kk), T::k_major(k_s + st * T::kTileBytes, BK, 0, kk),
                     kk > 0);"""
VARIANTS = {
    "design": [],
    "ablate_ex2_fmul": [(_EXP, _EXP.replace("ex2(", "0.5f * ("))],
    "ablate_no_rescale": [(_RESCALE, _RESCALE + "\n  return;")],
    "ablate_no_pack": [("hopper.cuh", _PACK, """p[kk][2 * h] = __byte_perm(__float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 1]), 0x7632);
      p[kk][2 * h + 1] = __byte_perm(__float_as_uint(s[4 * j + 2]), __float_as_uint(s[4 * j + 3]), 0x7632);""")],
    "ablate_no_row_max": [(_MAX_TREE_BLOCK + _MAX_SHUFFLES, "  float mx0 = 0.f, mx1 = 0.f;\n")],
    "ablate_no_l_product": [("kOnesInV = D <= 64;", "kOnesInV = false;"), (_ONES, "")],
    "ablate_no_pv_product": [(_PV, "")],
    "ablate_no_qk_product": [(_QK, "")],
    **{f"poly{n}": _poly(n) for n in (3, 4, 5, 8)},
    "rescale_vote": _rescale_vote(0),
    "rescale_slack8": _rescale_vote(8),
    "form_tiled": [],
    "form_resident": [],
    "rows64": [(_CONSUMERS, "static constexpr int kConsumers = D <= 64 ? 1 : 2;"),
               ("static constexpr int kConsumerRegs = 240;",
                "static constexpr int kConsumerRegs = kConsumers == 1 ? 232 : 240;"),
               *[(_BOUNDS, "__launch_bounds__(Bf16Tiles<D>::kThreads, Bf16Tiles<D>::kConsumers == 1 ? 2 : 1)")] * 2,
               (_RESIDENT_GRID, """const int per_sm = T::kConsumers == 1 && 232448 / smem >= 2 ? 2 : 1;
      const int grid = items < (long long)sms * per_sm ? (int)items : sms * per_sm;""")],
    "ones_in_v_none": [("kOnesInV = D <= 64;", "kOnesInV = false;")],
    "ones_in_v_d64": [("kOnesInV = D <= 64;", "kOnesInV = D == 64;")],
    "fill_old": _FILL_OLD,
    "pingpong_all": [("kPingPong = D == 128;", "kPingPong = true;")],
    "pingpong_none": [("kPingPong = D == 128;", "kPingPong = false;")],
    "issue_ahead_d32": [("kIssueAhead = D == 64;", "kIssueAhead = D <= 64;")],
    "issue_ahead_none": [("kIssueAhead = D == 64;", "kIssueAhead = false;")],
    "consumers3_d32": [("static constexpr int kConsumers = 2;", "static constexpr int kConsumers = D == 32 ? 3 : 2;")],
    "keys256_d32": [("static constexpr int kKeys = 128;", "static constexpr int kKeys = D == 32 ? 256 : 128;")],
    "l_in_registers": [
        # l = alpha l + rowsum(P) as P V adds the same tile: in pv_product, after the rescale
        (_ONES, _REGSUM),
        (_L_EPILOGUE, """  float l0 = l_acc[0], l1 = l_acc[2];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
"""),
    ],
    "row_max_serial": [(_MAX_TREE_BLOCK, """  float mx0 = s[0], mx1 = s[2];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
""")],
}
# Variants timed in one form of the bf16 kernel only, and variants whose results are wrong (not checked).
VARIANTS["ones_in_v_d64_fill_old"] = VARIANTS["ones_in_v_d64"] + _FILL_OLD
VARIANT_FORMS = {"form_tiled": "tiled", "form_resident": "resident", "l_in_registers": "tiled",
                 **{name: "tiled" for name in VARIANTS if name.startswith("ablate_")}}
TIMING_ONLY = {name for name in VARIANTS if name.startswith("ablate_")}
# The most keys the resident form holds, per head width (``Bf16Tiles::kResidentTiles`` tiles of 128).
RESIDENT_KEYS = {32: 1024}
_F32_CONSUMERS = "kConsumers = D <= 40 ? 2 : 1;"
_F32_KEYS = "kKeys = D == 128 ? 32 : 64;"
_F32_STAGES = "kStages = D == 32 ? 4 : (D == 128 ? 2 : 3);"
_F32_EXP = """s[4 * j] = ex2(s[4 * j] - n0);
    s[4 * j + 1] = ex2(s[4 * j + 1] - n0);
    s[4 * j + 2] = ex2(s[4 * j + 2] - n1);
    s[4 * j + 3] = ex2(s[4 * j + 3] - n1);"""
VARIANTS.update({
    "f32_no_pingpong": [("kPingPong = kConsumers == 2;", "kPingPong = false;")],
    "f32_one_consumer_d32": [(_F32_CONSUMERS, "kConsumers = D == 40 ? 2 : 1;")],
    "f32_keys32_d32": [(_F32_KEYS, "kKeys = D == 32 || D == 128 ? 32 : 64;")],
    "f32_two_consumers_d64": [(_F32_CONSUMERS, "kConsumers = D == 128 ? 1 : 2;"),
                              (_F32_KEYS, "kKeys = D <= 40 ? 64 : 32;")],
    "f32_keys32_d64": [(_F32_KEYS, "kKeys = D <= 40 ? 64 : 32;"),
                       (_F32_STAGES, "kStages = D == 128 ? 2 : (D == 40 ? 3 : 4);")],
    "f32_one_consumer_d40": [(_F32_CONSUMERS, "kConsumers = D == 32 ? 2 : 1;")],
    "f32_stages4_d40": [(_F32_STAGES, "kStages = D <= 40 ? 4 : (D == 64 ? 3 : 2);")],
    "f32_stages2_d40": [(_F32_STAGES, "kStages = D == 32 ? 4 : (D == 64 ? 3 : 2);")],
    "f32_keys32_d40": [(_F32_KEYS, "kKeys = D == 40 || D == 128 ? 32 : 64;")],
    # Ablations, for where the time goes (wrong results: timed only).
    "f32_ablate_1xtf32": [
        ("hopper.cuh", """for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 1), b(kk, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 0), b(kk, 1), 1);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 0), b(kk, 0), 1);""",
         "for (int kk = 0; kk < K; ++kk) wgmma_tf32_ss<N>(d, a(kk, 0), b(kk, 0), kk > 0);"),
        ("hopper.cuh", """for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_lo[kk], b(kk, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_hi[kk], b(kk, 1), 1);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_hi[kk], b(kk, 0), 1);""",
         "for (int kk = 0; kk < K; ++kk) wgmma_tf32_rs<N>(d, a_hi[kk], b(kk, 0), kk > 0);")],
    "f32_ablate_exp": [(_F32_EXP, """s[4 * j] = s[4 * j] - n0;
    s[4 * j + 1] = s[4 * j + 1] - n0;
    s[4 * j + 2] = s[4 * j + 2] - n1;
    s[4 * j + 3] = s[4 * j + 3] - n1;""")],
})
TIMING_ONLY |= {"f32_ablate_1xtf32", "f32_ablate_exp"}


def apply_edits(src: str, edits: list, name: str = "") -> str:
    """``src`` with each ``(anchor, replacement)`` of ``edits`` applied in turn to the anchor's first match.

    Anchors match on code tokens: whitespace between two tokens of the anchor matches any whitespace,
    or none, in the source.  Raises when an anchor is not found.
    """
    for old, new in edits:
        anchor = r"\s*".join(re.escape(tok) for tok in re.findall(r"\w+|\S", old))
        src, found = re.subn(anchor, lambda _, new=new: new.strip(), src, count=1)
        if not found:
            raise RuntimeError(f"variant {name}: anchor not in the source: {old!r}")
    return src


def variant_sources(csrc, source: str, edits: list, name: str = "") -> dict:
    """``{file name: text}`` of the files of the directory ``csrc`` that a variant's ``edits`` change.

    An edit ``(anchor, replacement)`` applies to ``<source>.cu``; ``(file, anchor, replacement)`` to
    another file of the directory (a header the source includes).
    """
    by_file: dict = {}
    for edit in edits:
        file, old, new = edit if len(edit) == 3 else (f"{source}.cu", *edit)
        by_file.setdefault(file, []).append((old, new))
    return {file: apply_edits((csrc / file).read_text(), file_edits, name) for file, file_edits in by_file.items()}


def note(line: str) -> str:
    """A ptxas note shortened to its code and the kernel it names (``C7511 flash_fwd_bf16_kernel<32>``)."""
    code = re.search(r"\((C\d+)\)", line)
    kernel = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]*?kernel)ILi(\d+)E", line)
    if code and kernel:
        return f"{code.group(1)} {kernel.group(1)}<{kernel.group(2)}>"
    return line.strip()[:160]


def build_variants(variants: dict, source: str = "flash_attn_fwd") -> dict:
    """Build every variant of ``csrc/<source>.cu`` (``{name: [edit, ...]}``, see :func:`variant_sources`)
    at once.

    Returns ``{name: ctypes.CDLL}``; prints each variant's nvcc status, ptxas's performance and error
    notes and the kernels that spill.
    """
    root = _build.BUILD_ROOT / "sweep" / source
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, edits in variants.items():
        out = root / name
        shutil.copytree(_build.CSRC, out)
        for file, text in variant_sources(_build.CSRC, source, edits, name).items():
            (out / file).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / f"{source}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        notes = [note(ln) for ln in log.splitlines() if "Performance Loss" in ln or "error" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(json.dumps({"variant": name, "nvcc_rc": proc.returncode, "ptxas_notes": notes, "spills": spills}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out / "lib.so"))
    return libs


def entry(lib: ctypes.CDLL, fn_name: str):
    """The C entry point ``fn_name`` of a variant's library, typed as the port's wrapper types it."""
    fn = getattr(lib, fn_name)
    fn.argtypes = next(fns[fn_name] for fns in fa._ENTRY_POINTS.values() if fn_name in fns)
    fn.restype = ctypes.c_int
    return fn


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def variant_form(name: str, m: int, d: int, dtype=torch.bfloat16):
    """The form a variant runs in at ``m`` keys and head width ``d``, or None where that form does not take
    the shape."""
    form = VARIANT_FORMS.get(name) if dtype == torch.bfloat16 else "tiled"
    if form is None:
        return fa.fwd_form(m, d, dtype)
    return None if form == "resident" and m > RESIDENT_KEYS.get(d, 0) else form


def sweep_shape(fns: dict, b: int, n: int, m: int, d: int, dtype=torch.bfloat16, iters: int = 30) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(b + n + m + d)
    q, k, v = (torch.randn((b, s, d), generator=gen, device="cuda").to(dtype) for s in (n, m, m))
    scale = 1.0 / math.sqrt(d)
    o, lse = torch.empty_like(q), torch.empty((b, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ref, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    bf16 = int(dtype == torch.bfloat16)
    parts = None if bf16 else fa.tf32_fwd_parts(q, k, v)
    ptrs = None if bf16 else (ctypes.c_void_p * len(parts))(*(parts[x].data_ptr() for x in fa.TF32_FWD_PARTS))
    forms = {name: variant_form(name, m, d, dtype) for name in fns}
    calls = {name: (lambda fn=fn, form=fa.FWD_FORMS.index(forms[name]):
                    fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                       b, n, m, d, bf16, scale, ptrs, form, stream))
             for name, fn in fns.items() if forms[name] is not None}
    rec = {"shape": [b, n, m, d], "dtype": str(dtype).split(".")[-1], "forms": forms, "max_abs_err": {},
           "lse_max_abs_err": {}, "ms": {name: [] for name in calls}}
    for name, call in calls.items():
        if call() != 0:
            raise RuntimeError(f"variant {name} failed to launch")
        torch.cuda.synchronize()
        if name in TIMING_ONLY:
            continue
        rec["max_abs_err"][name] = float((o.float() - ref.float()).abs().max())
        rec["lse_max_abs_err"][name] = float((lse - ref_lse).abs().max())
    for call in calls.values():  # every variant warm, so the first timed slot is not the card's ramp-up
        for _ in range(5):
            call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            for _ in range(3):
                calls[name]()
            start.record()
            for _ in range(iters):
                calls[name]()
            end.record()
            end.synchronize()
            rec["ms"][name].append(start.elapsed_time(end) / iters)
    return rec


def parse_args(argv, doc: str):
    """``--variants`` (shell patterns; ``design`` is always kept) and ``--d`` (head widths) narrow a sweep."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--variants", default="*", help="comma-separated shell patterns of variant names")
    parser.add_argument("--d", default="", help="comma-separated head widths of the shapes to time (all if empty)")
    args = parser.parse_args(argv)
    patterns = args.variants.split(",")
    widths = {int(x) for x in args.d.split(",") if x}
    keep = lambda name: name == "design" or any(fnmatch.fnmatch(name, p) for p in patterns)  # noqa: E731
    return keep, (lambda shape: not widths or shape[3] in widths)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    keep, timed = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    variants = {name: edits for name, edits in VARIANTS.items() if keep(name)}
    fns = {name: entry(lib, "mrisr_flash_attn_fwd") for name, lib in build_variants(variants).items()}
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
