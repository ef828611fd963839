"""The bf16 flash forward's exponentials and its two forms, on the CPU.

* The bf16 forward kernel's arithmetic (``csrc/flash_attn_fwd.cu``: tiles
  of 128 keys, the row maxima moved and O and l rescaled after every tile,
  p = exp2(s * scale * log2(e) - m) rounded to bf16 for P V and for the
  denominator) is emulated and held to JAX's Pallas forward in interpret
  mode at the unchanged ``chip_smoke.FLASH_TOL["bfloat16"]``.
* ``ops.flash_attention.fwd_form`` chooses the kernel's form (tiled or
  resident) from M and D; ``_launch`` passes it to the C entry point.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ops.flash_attention import _flash_fwd_impl
from mrisr_torch.ops import flash_attention as t_flash
from mrisr_torch.tools import flash_fwd_sweep
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = Path(__file__).resolve().parent.parent
SOURCE = (REPO / "mrisr_torch" / "csrc" / "flash_attn_fwd.cu").read_text()
LOG2E = 1.4426950408889634


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports only the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _c_value(expr: str, d: int):
    """A C constant expression of ``D`` and of other ``Bf16Tiles`` constants (ternaries, comparisons,
    arithmetic on integer literals) evaluated at ``D = d``."""
    expr = re.sub(r"\bk[A-Z]\w*", lambda m: str(_tile_constant(m.group(0), d)), expr)
    expr = re.sub(r"\bD\b", str(d), expr)
    while "(" in expr:  # the innermost parentheses first
        expr = re.sub(r"\(([^()]*)\)", lambda m: str(_ternary(m.group(1))), expr)
    return _ternary(expr)


def _ternary(expr: str):
    """``cond ? a : b`` (right-associative, no parentheses left) or a Python-compatible expression."""
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        return _ternary(a) if _ternary(cond) else _ternary(b)
    return eval(expr.replace("/", "//").replace("&&", " and ").replace("||", " or "),  # noqa: S307
                {"__builtins__": {}})


def _tile_constant(name: str, d: int) -> int:
    """``Bf16Tiles<d>::name`` as the kernel source defines it."""
    expr = re.search(rf"static constexpr int {name} = ([^;]+);", SOURCE).group(1)
    return int(_c_value(expr, d))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 fused multiply-add: the product exact in fp64, one rounding of the sum (to fp64, then fp32)."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64) + torch.as_tensor(c, dtype=torch.float64)).float()


def _b1_bf16_emulated(q, k, v, scale, bk=128):
    """The bf16 forward kernel's arithmetic on bf16-valued fp32 ``[B, N, D]`` inputs: tiles of ``bk`` keys
    (the last masked past M), row maxima in log2 units and O and l rescaled after every tile,
    p = exp2(s * sl2 - m) (ex2.approx within 2 ulp, taken as exact) rounded to bf16 for both P V and the
    denominator, O / l rounded to bf16, lse = m ln2 + ln l."""
    b, n, d = q.shape
    m_keys = k.shape[1]
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    scores = torch.einsum("bnd,bmd->bnm", q.double(), k.double()).float()
    m_row = torch.full((b, n), -math.inf)
    l_row = torch.zeros(b, n)
    o = torch.zeros(b, n, d)
    for t0 in range(0, m_keys, bk):
        s = torch.full((b, n, bk), -math.inf)
        s[:, :, : min(bk, m_keys - t0)] = scores[:, :, t0: t0 + bk]
        vt = torch.zeros(b, bk, d)
        vt[:, : min(bk, m_keys - t0)] = v[:, t0: t0 + bk]
        new = torch.maximum(m_row, s.max(dim=-1).values * sl2)
        alpha = torch.exp2(m_row - new)
        m_row = new
        p = torch.exp2(_fma(s, sl2, -m_row[..., None])).to(torch.bfloat16).float()
        l_row = l_row * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bnm,bmd->bnd", p, vt)
    lse = m_row / LOG2E + torch.log(l_row.clamp_min(1e-37))
    return (o / l_row[..., None]).to(torch.bfloat16).float(), lse


@functools.lru_cache(maxsize=None)
def _case(b, n, m, d, extreme):
    """bf16-valued inputs and JAX's Pallas forward on them (interpret mode, one block over each sequence)."""
    rng = np.random.default_rng(60 + n + m + d + extreme)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)) for s in (n, m, m))
    if extreme:
        q, k = _chip_smoke().extreme_qk(q, k)
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    if extreme:
        assert float((torch.einsum("bnd,bmd->bnm", q, k) * scale).max()) < -100.0
    oj, lj = _flash_fwd_impl(*(jnp.asarray(t.numpy()) for t in (q, k, v)), scale, n, m, interpret=True)
    return q, k, v, scale, torch.from_numpy(np.array(oj)), torch.from_numpy(np.array(lj)[:, 0])


def _shares(o, lse, want_o, want_lse, tol):
    """``chip_smoke.check_flash``'s three shares of the bf16 limits (each must be <= 1)."""
    rms_ref = float(want_o.square().mean().sqrt())
    err = (o - want_o).abs()
    worst = float((err / (tol["o_atol_rms"] * rms_ref + tol["o_rtol"] * want_o.abs())).max())
    rms_rel = float(err.square().mean().sqrt()) / rms_ref
    return worst, rms_rel / tol["o_rms_rel"], float((lse - want_lse).abs().max()) / tol["lse_atol"]


@pytest.mark.parametrize("b, n, m, extreme", [
    pytest.param(2, 300, 1000, False, id="normal"),
    pytest.param(2, 300, 1000, True, id="extreme"),
    pytest.param(2, 37, 5, False, id="short"),
])
def test_bf16_forward_emulation_meets_the_bf16_limits_against_jax(b, n, m, extreme):
    """The bf16 kernel's arithmetic at D=32 against JAX's forward: at 2x300x1000x32 (M ends mid-tile),
    where ``extreme`` puts every score near -130, so the maxima move on the first tile only, and at
    2x37x5x32 (fewer queries than a warp's rows, keys than a tile)."""
    q, k, v, scale, want_o, want_lse = _case(b, n, m, 32, extreme)
    o, lse = _b1_bf16_emulated(q, k, v, scale)
    shares = _shares(o, lse, want_o, want_lse, _chip_smoke().FLASH_TOL["bfloat16"])
    assert max(shares) <= 1.0, shares


@pytest.mark.parametrize("m, d, dtype, want", [
    pytest.param(16384, 32, torch.bfloat16, "tiled", id="site0_exact"),
    pytest.param(256, 32, torch.bfloat16, "resident", id="site0_fast"),
    pytest.param(4096, 64, torch.bfloat16, "tiled", id="site1_exact"),
    pytest.param(64, 64, torch.bfloat16, "tiled", id="site1_fast"),
    pytest.param(1, 32, torch.bfloat16, "resident", id="one_key"),
    pytest.param(t_flash.RESIDENT_MAX_KEYS[32], 32, torch.bfloat16, "resident", id="d32_bound"),
    pytest.param(t_flash.RESIDENT_MAX_KEYS[32] + 1, 32, torch.bfloat16, "tiled", id="d32_past"),
    pytest.param(1, 64, torch.bfloat16, "tiled", id="d64_one_key"),
    pytest.param(64, 128, torch.bfloat16, "tiled", id="d128"),
    pytest.param(256, 32, torch.float32, "tiled", id="fp32"),
])
def test_fwd_form_at_the_chain_shapes_and_bounds(m, d, dtype, want):
    assert t_flash.fwd_form(m, d, dtype) == want


def test_resident_bound_fits_the_kernel():
    """``RESIDENT_MAX_KEYS`` stays within what the resident kernel holds (``kResidentTiles`` tiles of
    ``kKeys``), and the sweep's capacities are the kernel's."""
    held = _tile_constant("kResidentTiles", 32) * _tile_constant("kKeys", 32)
    assert t_flash.RESIDENT_MAX_KEYS[32] <= held == flash_fwd_sweep.RESIDENT_KEYS[32]
    for d in (64, 128):  # no resident form: the launcher refuses it
        assert _tile_constant("kResidentTiles", d) == 0 and d not in t_flash.RESIDENT_MAX_KEYS
    assert set(t_flash.RESIDENT_MAX_KEYS) == set(flash_fwd_sweep.RESIDENT_KEYS)
    assert t_flash.FWD_FORMS == ("tiled", "resident")
    assert "enum Form { kTiled = 0, kResident = 1 };" in SOURCE


@pytest.mark.parametrize("m, d, dtype", [(16384, 32, torch.bfloat16), (256, 32, torch.bfloat16),
                                         (4096, 64, torch.bfloat16), (64, 64, torch.bfloat16),
                                         (256, 32, torch.float32)])
def test_launch_passes_the_form_to_the_kernel(monkeypatch, m, d, dtype):
    """``_launch`` hands the C entry point the index of ``fwd_form``'s choice (the argument before the
    stream), and nothing else of the call depends on it."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(t_flash, "_kernel_fn", lambda name: fake)
    monkeypatch.setattr(t_flash.torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(t_flash, "device_ctx", lambda device: contextlib.nullcontext())
    q = torch.zeros(1, 8, d, dtype=dtype)
    kv = torch.zeros(1, m, d, dtype=dtype)
    t_flash._launch(q, kv, kv, 0.25)
    (args,) = calls
    assert args[5:10] == (1, 8, m, d, t_flash.KERNEL_DTYPES[dtype])
    assert args[-2] == t_flash.FWD_FORMS.index(t_flash.fwd_form(m, d, dtype))
    assert len(args) == len(t_flash._ENTRY_POINTS["flash_attn_fwd"]["mrisr_flash_attn_fwd"])


def test_sweep_forms_and_timing_only_variants():
    """The sweep's forced forms and timing-only ablations name its variants; a forced resident form is
    skipped where the kernel cannot hold the keys, and the other variants take ``fwd_form``'s choice."""
    sw = flash_fwd_sweep
    assert set(sw.VARIANT_FORMS) <= set(sw.VARIANTS) and sw.TIMING_ONLY <= set(sw.VARIANTS)
    assert {name for name in sw.VARIANTS if "ablate" in name} == sw.TIMING_ONLY
    assert sw.variant_form("form_resident", 2048, 32) is None
    assert sw.variant_form("form_resident", 1024, 32) == "resident"
    assert sw.variant_form("form_resident", 64, 64) is None
    assert sw.variant_form("ablate_no_pack", 256, 32) == "tiled"
    assert sw.variant_form("design", 256, 32) == t_flash.fwd_form(256, 32, torch.bfloat16)
    assert sw.variant_form("design", 256, 32, torch.float32) == "tiled"
