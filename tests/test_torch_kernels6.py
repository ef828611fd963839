"""Head-width padding, the fp32 flash forward's 3xTF32 arithmetic and GroupNorm+SiLU's cluster plan, on the CPU.

* The flash kernels exist for D in (32, 64, 128), and the fp32 ones also
  for 40; the wrappers zero-pad a narrower head to the next width its kernel
  takes and slice the result back.  The padded plain
  path is held to the unpadded one and to JAX's Pallas kernels (interpret
  mode), which pad D themselves.
* The fp32 forward kernel computes in 3xTF32 on the tensor cores; its
  arithmetic, emulated here, is held to JAX's fp32 Pallas forward at the
  unchanged ``chip_smoke.FLASH_TOL["float32"]``.
* GroupNorm+SiLU cuts each (image, group) span over a thread-block cluster;
  the plan is checked for every shape the UNet runs and the ragged ones, and
  its constants against the kernel source.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ops.flash_attention import _flash_backward, _flash_fwd_impl
from mrisr_torch.ops import flash_attention as t_flash
from mrisr_torch.ops import groupnorm as t_gn
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "mrisr_torch" / "csrc"


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports only the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# D padding
# ---------------------------------------------------------------------------


_BF16, _FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d, dtype, kernel, want", [
    *(pytest.param(d, _BF16, "fwd", want, id=f"{d}-{want}")  # bf16 steps K by 16 columns: 40 pads to 64
      for d, want in [(1, 32), (16, 32), (32, 32), (33, 64), (40, 64), (64, 64), (80, 128), (128, 128)]),
    pytest.param(40, _FP32, "fwd", 40, id="40-float32-fwd-40"),  # tf32 steps K by 8: SD1.5's heads as they are
    pytest.param(33, _FP32, "fwd", 40, id="33-float32-fwd-40"),
    pytest.param(40, _FP32, "dkv", 40, id="40-float32-dkv-40"),
    pytest.param(36, _FP32, "dkv", 40, id="36-float32-dkv-40"),
    pytest.param(40, _FP32, "dq", 40, id="40-float32-dq-40"),
    pytest.param(36, _FP32, "dq", 40, id="36-float32-dq-40"),
    pytest.param(40, _BF16, "dkv", 64, id="40-bfloat16-dkv-64"),
    pytest.param(41, _FP32, "fwd", 64, id="41-float32-fwd-64"),
    pytest.param(16, _FP32, "dkv", 32, id="16-float32-dkv-32"),
])
def test_kernel_head_dim_is_the_next_kernel_width(d, dtype, kernel, want):
    """The width each kernel takes a head at, by dtype: the next of its ``KERNEL_HEAD_DIMS``."""
    assert t_flash.kernel_head_dim(d, dtype, kernel) == want
    assert want in t_flash.KERNEL_HEAD_DIMS[kernel, dtype]


@pytest.mark.parametrize("kernel, dtype, ok", [("fwd", _FP32, True), ("dkv", _FP32, True), ("dq", _FP32, True),
                                               ("fwd", _BF16, False), ("dkv", _BF16, False)])
def test_kernel_inputs_take_40_wide_heads_where_the_kernel_does(kernel, dtype, ok):
    """The launch check lets a 40-wide head reach the fp32 kernels only."""
    tensors = {n: torch.zeros(1, 8, 40, dtype=dtype) for n in ("q", "k", "v")}
    if ok:
        t_flash._check_kernel_inputs(40, 1, kernel, **tensors)
    else:
        with pytest.raises(ValueError, match="D in"):
            t_flash._check_kernel_inputs(40, 1, kernel, **tensors)


def test_kernel_head_dims_match_the_sources():
    """``KERNEL_HEAD_DIMS`` is what the C entry points dispatch: the forward's launch_bf16 / launch_f32
    cases, the backward's launch_dq / launch_dkv cases (the fp32 widths; each refuses bf16 at D=40 at
    compile time, leaving the bf16 widths)."""
    import re

    fwd = (CSRC / "flash_attn_fwd.cu").read_text()
    bwd = (CSRC / "flash_attn_bwd.cu").read_text()
    cases = lambda src, fn: tuple(sorted(int(x) for x in re.findall(rf"case (\d+): return \(int\){fn}<\1>", src)))  # noqa: E731
    assert cases(fwd, "launch_bf16") == t_flash.KERNEL_HEAD_DIMS["fwd", _BF16]
    assert cases(fwd, "launch_f32") == t_flash.KERNEL_HEAD_DIMS["fwd", _FP32]
    refusal = "if (bf16) {\n    if constexpr (D == 40) {\n      return cudaErrorInvalidValue;  // bf16"
    for kernel in ("dq", "dkv"):
        launch = bwd[bwd.index(f"cudaError_t launch_{kernel}("):]
        launch = launch[:launch.index("\n}\n")]  # the function's body
        assert refusal in launch, kernel
        assert cases(bwd, f"launch_{kernel}") == t_flash.KERNEL_HEAD_DIMS[kernel, _FP32]
        assert tuple(d for d in cases(bwd, f"launch_{kernel}") if d != 40) == t_flash.KERNEL_HEAD_DIMS[kernel, _BF16]


@pytest.mark.parametrize("d", [129, 160, 0])
def test_kernel_head_dim_names_what_no_kernel_takes(d):
    with pytest.raises(ValueError, match=f"D={d}"):
        t_flash.kernel_head_dim(d)


def test_pad_head_dim_appends_zero_columns():
    x = torch.from_numpy(_normal(np.random.default_rng(40), 2, 5, 16))
    p = t_flash._pad_head_dim(x, 32)
    assert p.shape == (2, 5, 32) and torch.equal(p[..., :16], x) and not p[..., 16:].any()
    assert t_flash._pad_head_dim(x, 16) is x


@pytest.mark.parametrize("b,n,m,d", [(2, 256, 192, 16), (2, 130, 70, 40), (1, 64, 64, 80)])
def test_padded_head_is_exact_against_the_unpadded_plain_path_and_jax(b, n, m, d):
    """Pad D to the kernels' width, run the plain forward and backward, slice: the unpadded results, and
    JAX's Pallas forward and backward (interpret mode, its own padding) on the same inputs."""
    rng = np.random.default_rng(41 + d)
    q, k, v, g = (_normal(rng, b, s, d) for s in (n, m, m, n))
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kd = t_flash.kernel_head_dim(d)
    pq, pk, pv, pg = (t_flash._pad_head_dim(t, kd) for t in (tq, tk, tv, tg))
    o_pad, lse_pad = t_flash.flash_attention_plain(pq, pk, pv, scale)
    o, lse = t_flash.flash_attention_plain(tq, tk, tv, scale)
    assert not o_pad[..., d:].any()
    torch.testing.assert_close(o_pad[..., :d], o, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse_pad, lse, atol=1e-6, rtol=0)
    grads_pad = t_flash.flash_attention_bwd_plain(pq, pk, pv, o_pad, lse_pad, pg, scale)
    grads = t_flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, scale)
    for gp, gu in zip(grads_pad, grads):
        assert not gp[..., d:].any()
        torch.testing.assert_close(gp[..., :d], gu, atol=1e-6, rtol=0)

    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    oj, lj = _flash_fwd_impl(jq, jk, jv, scale, max(n, m), max(n, m), interpret=True)
    np.testing.assert_allclose(o_pad[..., :d].numpy(), np.asarray(oj), atol=2e-5)
    np.testing.assert_allclose(lse_pad.numpy(), np.asarray(lj)[:, 0], atol=2e-5)
    want = _flash_backward(jq, jk, jv, oj, lj, jg, scale, max(n, m), interpret=True)
    for gp, w in zip(grads_pad, want):
        np.testing.assert_allclose(gp[..., :d].numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The fp32 forward kernel's arithmetic (3xTF32), emulated on the CPU
# ---------------------------------------------------------------------------


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the tensor cores read it (13 low mantissa bits dropped; ``tools/tf32_probe.py``)."""
    return (x.contiguous().view(torch.int32) & t_flash.TF32_MASK).view(torch.float32).double()


def _product(a_hi, a_lo, b_hi, b_lo, passes=3):
    """``sum_k a[b, i, k] b[b, j, k]`` as the kernel's tf32 products take it: lo hi + hi lo + hi hi, or hi
    hi alone with ``passes=1``; each operand as the tensor cores read it, the tile's sum in float64."""
    out = _tf32_read(a_hi) @ _tf32_read(b_hi).transpose(1, 2)
    if passes == 3:
        out = (out + _tf32_read(a_lo) @ _tf32_read(b_hi).transpose(1, 2)
               + _tf32_read(a_hi) @ _tf32_read(b_lo).transpose(1, 2))
    return out.float()


def _tf32_forward_emulated(q, k, v, scale, bk, passes=3):
    """``(o, lse)`` as the fp32 forward kernel computes them, tile by tile of ``bk`` keys: S from
    ``tf32_fwd_parts`` of Q and K, scaled by scale * log2(e) and masked past M, the online softmax in
    fp32 with exp2, the row sums of p in fp32, P split into tf32 parts in registers and multiplied by the
    permuted V^T (``transpose_permuted``) into a fresh part that is added to alpha O in fp32."""
    parts = t_flash.tf32_fwd_parts(q, k, v)
    b, n, _ = q.shape
    m = k.shape[1]
    sl2 = scale * 1.4426950408889634
    s_all = _product(parts["q_hi"], parts["q_lo"], parts["k_hi"], parts["k_lo"], passes) * sl2
    mp = parts["vt"].shape[2]
    s_all = torch.nn.functional.pad(s_all, (0, mp - m), value=-math.inf)  # keys past M: -inf
    row_max = torch.full((b, n), -math.inf)
    l_sum = torch.zeros(b, n)
    o = torch.zeros(b, n, q.shape[2])
    for t in range(0, m, bk):
        s = s_all[..., t : t + bk]
        new_max = torch.maximum(row_max, s.amax(-1))
        alpha = torch.exp2(row_max - new_max)
        p = torch.exp2(s - new_max[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        # A = P with its keys permuted as in V^T (a thread's columns 2t, 2t+1 are its k t, t+4).
        p_perm = t_flash.transpose_permuted(p.transpose(1, 2), pad=8)
        part = _product(t_flash.tf32_hi(p_perm), t_flash.tf32_lo(p_perm), parts["vt"][..., t : t + bk],
                        parts["vt_lo"][..., t : t + bk], passes)
        o = o * alpha[..., None] + part
        row_max = new_max
    return o / l_sum[..., None], row_max * math.log(2.0) + torch.log(l_sum)


def _within_fwd(o, lse, want_o, want_lse, tol):
    """``chip_smoke.py``'s forward check: every element of O within o_atol_rms * rms(ref) + o_rtol *
    |ref|, rms(err) within o_rms_rel * rms(ref), lse within lse_atol.  Returns the three ratios."""
    rms_ref = float(want_o.square().mean().sqrt())
    err = (o - want_o).abs()
    worst = float((err / (tol["o_atol_rms"] * rms_ref + tol["o_rtol"] * want_o.abs())).max())
    rms_rel = float(err.square().mean().sqrt()) / rms_ref
    return worst, rms_rel / tol["o_rms_rel"], float((lse - want_lse).abs().max()) / tol["lse_atol"]


@pytest.mark.parametrize("b,n,m,d,bk,extreme", [
    pytest.param(2, 256, 256, 32, 64, False, id="2-256-256-32"),
    pytest.param(2, 128, 192, 64, 64, False, id="2-128-192-64"),
    pytest.param(2, 37, 5, 32, 64, False, id="ragged-2-37-5-32"),
    pytest.param(2, 130, 70, 128, 32, False, id="ragged-2-130-70-128"),
    pytest.param(2, 100, 60, 64, 64, True, id="extreme-2-100-60-64"),
    # SD1.5's 40-wide heads, unpadded (5 k-steps, P V at N = 40), at the padding test's shape (JAX's programs
    # are those it runs)
    pytest.param(2, 130, 70, 40, 64, False, id="ragged-2-130-70-40"),
    pytest.param(2, 130, 70, 40, 64, True, id="extreme-2-130-70-40"),
])
def test_tf32_forward_emulation_meets_the_fp32_limits_against_jax(b, n, m, d, bk, extreme):
    """The fp32 forward kernel's arithmetic (3xTF32 with the tensor cores' truncation, lo lo dropped, the
    permuted P V order, a fresh part a tile; ``bk`` keys a tile as ``F32Tiles`` has them) against JAX's
    fp32 forward (the Pallas kernel in interpret mode) at the unchanged ``FLASH_TOL["float32"]``.
    ``extreme``: every score below -100, so a key past M that scored 0 would swamp the row."""
    rng = np.random.default_rng(50 + n + m + d)
    q, k, v = (_normal(rng, b, s, d) for s in (n, m, m))
    scale = 1.0 / math.sqrt(d)
    if extreme:
        q, k = (t.numpy() for t in _chip_smoke().extreme_qk(torch.from_numpy(q), torch.from_numpy(k)))
        assert (np.einsum("bnd,bmd->bnm", q, k) * scale).max() < -100.0
    oj, lj = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, max(n, m), max(n, m),
                             interpret=True)
    o, lse = _tf32_forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)), scale, bk)
    tol = _chip_smoke().FLASH_TOL["float32"]
    ratios = _within_fwd(o, lse, torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lj)[:, 0]), tol)
    assert max(ratios) <= 1.0, ratios


def test_one_tf32_pass_forward_falls_short_of_the_fp32_limits():
    """Why three passes: the hi hi products alone (1xTF32) miss ``FLASH_TOL["float32"]``."""
    rng = np.random.default_rng(51)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 256, 32)) for _ in range(3))
    scale = 1.0 / math.sqrt(32)
    want_o, want_lse = t_flash.flash_attention_plain(q, k, v, scale)
    tol = _chip_smoke().FLASH_TOL["float32"]
    assert max(_within_fwd(*_tf32_forward_emulated(q, k, v, scale, 64), want_o, want_lse, tol)) <= 1.0
    one = _within_fwd(*_tf32_forward_emulated(q, k, v, scale, 64, passes=1), want_o, want_lse, tol)
    assert one[1] > 1.0, one  # rms error over its limit


def _tf32_np(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to tf32 to nearest, ties away from zero, in numpy."""
    return ((x.view(np.int32).astype(np.int64) + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("n,m,d", [(64, 128, 32), (37, 5, 32), (130, 70, 128), (1, 333, 64)])
def test_tf32_fwd_parts_match_numpy(n, m, d):
    """The forward's prep: hi/lo split of q and k; v's parts transposed, zero padded to a multiple of 64
    keys and permuted within each group of 8."""
    rng = np.random.default_rng(52)
    q, k, v = ((rng.standard_normal((2, s, d)) * 2.0 ** rng.integers(-4, 5, (2, s, d))).astype(np.float32)
               for s in (n, m, m))
    parts = t_flash.tf32_fwd_parts(*(torch.from_numpy(a) for a in (q, k, v)))
    assert tuple(parts) == t_flash.TF32_FWD_PARTS
    for name, x in (("q", q), ("k", k)):
        hi = _tf32_np(x)
        np.testing.assert_array_equal(parts[f"{name}_hi"].numpy(), hi)
        np.testing.assert_array_equal(parts[f"{name}_lo"].numpy(), _tf32_np(x - hi))
    hi = _tf32_np(v)
    for key, src in (("vt", hi), ("vt_lo", _tf32_np(v - hi))):
        want = np.zeros((2, d, -(-m // 64) * 64), np.float32)
        for r in range(m):
            g8, rest = divmod(r, 8)
            want[:, :, 8 * g8 + 4 * (rest % 2) + rest // 2] = src[:, r, :]
        np.testing.assert_array_equal(parts[key].numpy(), want)
    t_flash._check_parts(torch.from_numpy(q), torch.from_numpy(k), parts, t_flash.TF32_FWD_PARTS)


def _misaligned(shape):
    """A contiguous fp32 view one element into its storage: 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 4)[1 : n + 1].view(shape)


@pytest.mark.parametrize("case, bad, error, match", [
    ("backward_parts", lambda q, p: t_flash.tf32_parts(q, q, q, q), ValueError, "take the parts"),
    ("missing", lambda q, p: {n: t for n, t in p.items() if n != "vt_lo"}, ValueError, "take the parts"),
    ("wrong_shape", lambda q, p: p | {"vt": torch.zeros(1, 32, 8)}, ValueError, "part vt"),
    ("bf16_part", lambda q, p: p | {"k_lo": p["k_lo"].to(torch.bfloat16)}, TypeError, "part k_lo"),
    ("strided", lambda q, p: p | {"q_hi": torch.zeros(1, 32, 8).transpose(1, 2)}, ValueError, "contiguous q_hi"),
    ("misaligned", lambda q, p: p | {"k_hi": _misaligned((1, 8, 32))}, ValueError, "16-byte aligned k_hi"),
    ("for_bf16", lambda q, p: None, None, None),
])
def test_fp32_forward_parts_are_checked(case, bad, error, match):
    """The fp32 forward kernel's ``parts`` argument: its six parts, of their shapes, float32, contiguous
    and aligned; and none for bf16."""
    q = torch.zeros(1, 8, 32)
    parts = t_flash.tf32_fwd_parts(q, q, q)
    t_flash._check_parts(q, q, parts, t_flash.TF32_FWD_PARTS)
    if error is None:  # bf16 takes no parts, and refuses them
        qb = q.to(torch.bfloat16)
        t_flash._check_parts(qb, qb, None, t_flash.TF32_FWD_PARTS)
        with pytest.raises(ValueError, match="float32 inputs only"):
            t_flash._check_parts(qb, qb, parts, t_flash.TF32_FWD_PARTS)
        return
    with pytest.raises(error, match=match):
        t_flash._check_parts(q, q, bad(q, parts), t_flash.TF32_FWD_PARTS)


def test_forward_parts_match_the_kernel_source():
    """The forward's C interface reads its parts in ``TF32_FWD_PARTS`` order, V^T's rows padded alike."""
    src = (CSRC / "flash_attn_fwd.cu").read_text()
    assert f"constexpr int kTransposePad = {t_flash.TRANSPOSE_PAD};" in src
    names = src[src.index("enum Part {"):].split("{")[1].split("}")[0]
    want = ["k" + "".join(w.capitalize() for w in n.split("_")) for n in t_flash.TF32_FWD_PARTS]
    assert [x.strip() for x in names.split(",")] == want


# ---------------------------------------------------------------------------
# GroupNorm+SiLU: the cluster plan
# ---------------------------------------------------------------------------

_GN_SHAPES = [pytest.param(shape, groups, id=f"{case}-{'x'.join(map(str, shape))}-g{groups}")
              for case, shape, groups in _chip_smoke().GN_CASES + _chip_smoke().GN_RAGGED]


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape, groups", _GN_SHAPES)
def test_gn_plan_cuts_each_span_into_slices_that_fit(shape, groups, elem_size):
    """The fewest CTAs (1, 2, 4, 8) that keep a slice at the target or under, every CTA with work, whole
    16-byte units where H*W allows, and a slice kept in shared memory exactly when it fits."""
    _, c, h, w = shape
    plan = t_gn.gn_plan(shape, groups, elem_size)
    span = c // groups * h * w
    assert plan.span == span and plan.cluster in (1, 2, 4, 8)
    assert plan.vec == ((h * w * elem_size) % 16 == 0)
    assert plan.chunk % (16 // elem_size if plan.vec else 1) == 0
    assert plan.chunk * plan.cluster >= span > plan.chunk * (plan.cluster - 1)
    fits = lambda cl: span * elem_size <= cl * t_gn.GN_SLICE_TARGET  # noqa: E731
    assert fits(plan.cluster) or plan.cluster == t_gn.GN_MAX_CLUSTER
    assert plan.cluster == 1 or not fits(plan.cluster // 2)
    assert plan.resident == (plan.chunk * elem_size <= t_gn.GN_MAX_SLICE_BYTES)


def test_gn_plan_keeps_every_span_of_the_unet_resident():
    """Every head of the chain keeps x in shared memory (read once) in bf16 and fp32; the largest takes
    eight CTAs of 98 KB in bf16; spans of 64 KB or less take one CTA; the re-read case does not fit."""
    smoke = _chip_smoke()
    for _, shape, groups in smoke.GN_CASES:
        for elem in (2, 4):
            plan = t_gn.gn_plan(shape, groups, elem)
            assert plan.resident and plan.vec, (shape, elem)
            if plan.span * elem <= 64 * 1024:
                assert plan.cluster == 1
    largest = t_gn.gn_plan((8, 96, 256, 256), 16, 2)
    assert (largest.cluster, largest.chunk * 2) == (8, 98304)
    assert [case for case, shape, groups in smoke.GN_RAGGED
            if not t_gn.gn_plan(shape, groups, 2).resident] == ["reread"]
    assert len(smoke.GN_CASES) == 13


def test_gn_plan_constants_match_the_kernel_source():
    src = (CSRC / "group_norm_silu.cu").read_text()
    for name, value in (("kMaxCluster", "8"), ("kSliceTarget", "64 * 1024"), ("kMaxSliceBytes", "224 * 1024")):
        assert f"constexpr int {name} = {value};" in src, name
    assert (t_gn.GN_MAX_CLUSTER, t_gn.GN_SLICE_TARGET, t_gn.GN_MAX_SLICE_BYTES) == (8, 64 * 1024, 224 * 1024)
    assert t_gn.GN_MAX_SLICE_BYTES + 1024 <= 232448  # a slice and the reductions (144 bytes) fit a CTA


def test_group_norm_silu_kernel_inputs_are_checked():
    """What the launch refuses before it reaches the card (CPU tensors stand in)."""
    x = torch.zeros(2, 8, 4, 4)
    w = torch.ones(8)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        t_gn._launch(x.double(), w, w, 4, 1e-5)
    with pytest.raises(ValueError, match="contiguous NCHW"):
        t_gn._launch(x.transpose(2, 3), w, w, 4, 1e-5)
    with pytest.raises(TypeError, match="weight and bias"):
        t_gn._launch(x.to(torch.bfloat16), w, w, 4, 1e-5)


@pytest.mark.parametrize("name", sorted(__import__("mrisr_torch.tools.gn_sweep", fromlist=["VARIANTS"]).VARIANTS))
def test_gn_sweep_variants_apply_to_the_source(name):
    """Every design variant of ``gn_sweep`` finds its anchors in the checked-in source and changes it; the
    slice-target variants cut plans that keep the largest head's span."""
    from mrisr_torch.tools import gn_sweep
    from mrisr_torch.tools.flash_fwd_sweep import variant_sources

    edits = gn_sweep.VARIANTS[name]
    out = variant_sources(CSRC, "group_norm_silu", edits, name)
    assert sorted(out) == (["group_norm_silu.cu"] if edits else [])
    assert all(text != (CSRC / file).read_text() for file, text in out.items())
    for target in gn_sweep.TARGETS.values():
        plan = t_gn.gn_plan((8, 96, 256, 256), 16, 2, target)
        assert plan.cluster * plan.chunk >= plan.span and plan.resident
