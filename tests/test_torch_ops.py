"""The PyTorch port's diffusion math and ops against the JAX reference, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.  The
two kernels' plain versions (the path a CPU tensor takes) are held to the
JAX Pallas kernels run in interpret mode.  Tolerances are float32 rounding
of differently ordered sums unless stated otherwise.
"""
from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.diffusion import ddim as j_ddim
from mrisr_tpu.diffusion import ddpm as j_ddpm
from mrisr_tpu.diffusion import schedules as j_sched
from mrisr_tpu.ops import attention as j_attn
from mrisr_tpu.ops.flash_attention import _flash_backward, _flash_fwd_impl
from mrisr_tpu.ops.fourier import gaussian_highpass_split as j_split
from mrisr_tpu.ops.groupnorm import _gn_silu_forward, group_norm_silu_reference
from mrisr_tpu.ops.wavelets import haar_dwt_highpass_sum as j_dwt
from mrisr_torch.diffusion import ddim as t_ddim
from mrisr_torch.diffusion import ddpm as t_ddpm
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.ops import attention as t_attn
from mrisr_torch.ops import flash_attention as t_flash
from mrisr_torch.ops import groupnorm as t_gn
from mrisr_torch.ops.fourier import gaussian_highpass_split as t_split
from mrisr_torch.ops.wavelets import haar_dwt_highpass_sum as t_dwt

REPO = Path(__file__).resolve().parent.parent
SCHEDULE_FIELDS = (
    "betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread while a port test file runs (every ``test_torch_*`` file imports this fixture).

    The suite runs six workers on eight cores beside XLA's own thread pools;
    torch's default of one thread per core then spends most of a small op
    waiting for threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize(
    "args",
    [
        ("linear", 1000, 1e-6, 1e-2, False),
        ("scaled_linear", 1000, 0.00085, 0.012, True),
        ("cosine", 50, 1e-4, 0.02, False),
    ],
)
def test_schedule_tables_match(args):
    kind, T, b0, b1, zsnr = args
    sj = j_sched.make_schedule(kind, T, b0, b1, zero_terminal_snr=zsnr)
    st = t_sched.make_schedule(kind, T, b0, b1, zero_terminal_snr=zsnr)
    assert st.num_timesteps == sj.num_timesteps == T
    for name in SCHEDULE_FIELDS:
        # Same float64 numpy math cast to float32 on both sides: bit-equal.
        np.testing.assert_array_equal(_np(getattr(st, name)), _np(getattr(sj, name)), err_msg=name)


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
def test_spaced_timesteps_match(spacing):
    for n in (4, 50, 1000):
        np.testing.assert_array_equal(
            t_sched.spaced_timesteps(1000, n, spacing), j_sched.spaced_timesteps(1000, n, spacing)
        )


@pytest.mark.parametrize("clip", [True, False])
def test_ddim_step_and_ddpm_math_match(clip):
    rng = np.random.default_rng(1)
    sj, st = j_sched.resdiff_schedule(1000), t_sched.resdiff_schedule(1000)
    x = rng.standard_normal((3, 1, 8, 8)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([999, 500, 19])
    tp = np.array([979, 480, -1])
    want = j_ddim.ddim_step(sj, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tp), jnp.asarray(eps), clip_x0=clip)
    got = t_ddim.ddim_step(st, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(tp),
                           torch.from_numpy(eps), clip_x0=clip)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=1e-5)
    for name in ("q_sample", "predict_x0_from_eps", "predict_eps_from_x0"):
        a = getattr(j_ddpm, name)(sj, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
        b = getattr(t_ddpm, name)(st, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(eps))
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=1e-5, err_msg=name)


def test_ddim_step_keeps_carry_dtype_and_needs_generator_for_eta():
    st = t_sched.resdiff_schedule(1000)
    x = torch.randn(2, 1, 4, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    t, tp = torch.tensor([999, 999]), torch.tensor([979, 979])
    assert t_ddim.ddim_step(st, x, t, tp, x).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        t_ddim.ddim_step(st, x, t, tp, x, eta=0.5)
    a = t_ddim.ddim_step(st, x, t, tp, x, torch.Generator().manual_seed(3), eta=0.5)
    b = t_ddim.ddim_step(st, x, t, tp, x, torch.Generator().manual_seed(3), eta=0.5)
    assert torch.equal(a, b) and not torch.equal(a, t_ddim.ddim_step(st, x, t, tp, x))


def test_fourier_split_and_haar_dwt_match_at_batch_2():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 32, 32)).astype(np.float32)
    sigma = np.array([[14.0], [20.5]], np.float32)
    fj, hj = j_split(jnp.asarray(x), jnp.asarray(sigma))
    ft, ht = t_split(torch.from_numpy(x), torch.from_numpy(sigma))
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), atol=2e-5, rtol=1e-5)
    for a, b in zip(j_dwt(jnp.asarray(x), 3), t_dwt(torch.from_numpy(x), 3)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,m,d", [(1024, 1024, 16), (1024, 64, 32)])
def test_dense_and_chunked_attention_match(n, m, d):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32) for s in (n, m, m))
    args_j = tuple(jnp.asarray(a) for a in (q, k, v))
    args_t = tuple(torch.from_numpy(a) for a in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(j_attn.dense_attention(*args_j, scale))
    np.testing.assert_allclose(_np(t_attn.dense_attention(*args_t, scale)), want, atol=2e-6)
    np.testing.assert_allclose(_np(t_attn.chunked_attention(*args_t, scale)), want, atol=2e-6)
    np.testing.assert_allclose(
        _np(t_attn.chunked_attention(*args_t, scale)),
        np.asarray(j_attn.chunked_attention(*args_j, scale)), atol=2e-6,
    )


def test_cross_attention_dispatch_at_4096_tokens_matches():
    """n >= 4096 on a CPU tensor takes the flash function's plain q-chunked path: no launch."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 4096, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_attn.cross_attention_2d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = t_flash.flash_attention_fwd.launches
    got = t_attn.cross_attention_2d(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(_np(got), want, atol=2e-6)
    assert t_flash.flash_attention_fwd.launches == before


@pytest.mark.parametrize("image_size,tokens", [(128, 4096), (136, 4624)])
def test_cpu_unet_runs_the_flash_plain_version_at_4096_tokens(monkeypatch, image_size, tokens):
    """One plain attention path: a CPU UNet's CA site with >= 4096 tokens runs B1's plain version.

    4624 tokens is no multiple of 512: the q-chunked reference path would
    have turned dense there.  The result equals the all-dense forward.
    """
    from mrisr_torch.models.resdiff_unet import ResDiffUNet

    torch.manual_seed(0)
    unet = ResDiffUNet(image_size=image_size, inner_channel=8, norm_groups=4, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 2, image_size, image_size), generator=gen)
    gamma = torch.tensor([0.6])
    calls = []
    plain = t_flash.flash_attention_plain
    monkeypatch.setattr(t_flash, "flash_attention_plain",
                        lambda q, k, v, scale: calls.append(q.shape[1]) or plain(q, k, v, scale))
    with torch.no_grad():
        got = unet(x, gamma)
        assert calls == [tokens]  # the next site has a quarter of the tokens and is dense
        monkeypatch.setattr(t_attn, "CHUNK_THRESHOLD", 10**9)
        want = unet(x, gamma)
    assert calls == [tokens] and t_flash.flash_attention_fwd.launches == 0
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize(
    "n,m,d,bq,bk",
    [(256, 256, 32, 128, 128), (512, 256, 64, 128, 256), (200, 136, 32, 200, 136), (64, 64, 128, 64, 64)],
)
def test_flash_plain_matches_jax_kernel(n, m, d, bq, bk):
    """B1's plain version (o and lse) against the Pallas kernel in interpret mode.

    (200, 136) is a ragged length: one block spans the whole sequence.
    """
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32) for s in (n, m, m))
    scale = 1.0 / np.sqrt(d)
    oj, lj = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, bq, bk, interpret=True)
    ot, lt = t_flash.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert ot.shape == (2, n, d) and lt.shape == (2, n) and lt.dtype == torch.float32
    np.testing.assert_allclose(_np(ot), np.asarray(oj), atol=2e-5)
    np.testing.assert_allclose(_np(lt), np.asarray(lj)[:, 0], atol=2e-5)


def test_flash_plain_chunks_ragged_queries():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, s, 32)).astype(np.float32) for s in (1300, 700, 700))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o1, l1 = t_flash.flash_attention_plain(*args, 0.2, chunk=512)
    o2, l2 = t_flash.flash_attention_plain(*args, 0.2, chunk=4096)
    torch.testing.assert_close(o1, o2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l1, l2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(o1, t_attn.dense_attention(*args, 0.2), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((1, 16, 16, 32), 16), ((2, 6, 10, 12), 3)])
def test_group_norm_silu_plain_matches_jax_kernel(shape, groups):
    """B3's plain version against the Pallas kernel (interpret mode) and its reference."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
    c = shape[-1]
    w = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5)
    kern = np.asarray(_gn_silu_forward(*args, interpret=True))
    ref = np.asarray(group_norm_silu_reference(*args))
    before = t_gn.group_norm_silu.launches
    got = t_gn.group_norm_silu(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                               torch.from_numpy(w), torch.from_numpy(b), groups)
    got = _np(got.permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert t_gn.group_norm_silu.launches == before


def test_wrappers_reject_bad_input():
    x = torch.zeros(2, 6, 4, 4)
    with pytest.raises(ValueError):
        t_gn.group_norm_silu(x, torch.ones(6), torch.zeros(6), 4)
    with pytest.raises(ValueError):
        t_flash.flash_attention_fwd(torch.zeros(1, 8, 32), torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), 1.0)
    with pytest.raises(TypeError):
        t_flash.flash_attention_fwd(torch.zeros(1, 8, 32), torch.zeros(1, 8, 32).double(),
                                    torch.zeros(1, 8, 32), 1.0)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view one element into its storage: 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1 : n + 1].view(shape)


_QKV = dict(q=(1, 8, 32), k=(1, 8, 32), v=(1, 8, 32))


def _bwd(**bad):
    """The backward kernels' other inputs (dO, lse, delta), as they take them, with ``bad`` replacing some."""
    return dict(do=torch.zeros(1, 8, 32, dtype=torch.bfloat16), lse=torch.zeros(1, 8), delta=torch.zeros(1, 8)) | bad


@pytest.mark.parametrize(
    "case, make, error, match",
    [
        ("q_at_storage_offset", lambda: dict(q=_misaligned((1, 8, 32))), ValueError, "16-byte aligned q"),
        ("v_at_storage_offset", lambda: dict(v=_misaligned((1, 8, 32))), ValueError, "16-byte aligned v"),
        ("k_transposed", lambda: dict(k=torch.zeros(1, 32, 8, dtype=torch.bfloat16).transpose(1, 2)),
         ValueError, "contiguous k"),
        ("d_16", lambda: {n: torch.zeros(1, 8, 16, dtype=torch.bfloat16) for n in _QKV}, ValueError, "D in"),
        ("d_48", lambda: {n: torch.zeros(1, 8, 48, dtype=torch.bfloat16) for n in _QKV}, ValueError, "D in"),
        ("float16", lambda: {n: torch.zeros(s, dtype=torch.float16) for n, s in _QKV.items()}, TypeError,
         "bfloat16 or float32"),
        # The backward's inputs: dO goes through TMA like q, k, v; lse and delta are read by row.
        ("do_at_storage_offset", lambda: _bwd(do=_misaligned((1, 8, 32))), ValueError, "16-byte aligned do"),
        ("do_transposed", lambda: _bwd(do=torch.zeros(1, 32, 8, dtype=torch.bfloat16).transpose(1, 2)),
         ValueError, "contiguous do"),
        ("lse_at_storage_offset", lambda: _bwd(lse=_misaligned((1, 8), torch.float32)), ValueError,
         "16-byte aligned lse"),
        ("lse_strided", lambda: _bwd(lse=torch.zeros(1, 16)[:, ::2]), ValueError, "contiguous lse"),
        ("delta_at_storage_offset", lambda: _bwd(delta=_misaligned((1, 8), torch.float32)), ValueError,
         "16-byte aligned delta"),
        ("delta_strided", lambda: _bwd(delta=torch.zeros(1, 16)[:, ::2]), ValueError, "contiguous delta"),
    ],
)
def test_kernel_inputs_reject_what_the_kernels_cannot_take(case, make, error, match):
    """The checks every kernel launch runs first, on CPU tensors: TMA needs 16-byte aligned,
    contiguous rows, and the kernels exist for D in (32, 64, 128) only."""
    tensors = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in _QKV.items()} | make()
    with pytest.raises(error, match=match):
        t_flash._check_kernel_inputs(tensors["q"].shape[2], 1, **tensors)
    # The same tensors, aligned, contiguous and of a kernel's D and dtype, pass.
    t_flash._check_kernel_inputs(32, 1, **{n: torch.zeros(s, dtype=torch.bfloat16) for n, s in _QKV.items()})
    t_flash._check_kernel_inputs(32, 1, **{n: torch.zeros(s, dtype=torch.bfloat16) for n, s in _QKV.items()},
                                 **_bwd())


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports only the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ANON = "_ZN50_GLOBAL__N__d04f5a53_17_flash_attn_{}_cu_2c337719"  # nvcc's anonymous namespace of a source


@pytest.mark.parametrize("mangled, name", [
    (_ANON.format("fwd") + "21flash_fwd_bf16_kernelILi32EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiif",
     "flash_fwd_bf16_kernel<32>"),
    (_ANON.format("bwd") + "24flash_bwd_dq_bf16_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiff",
     "flash_bwd_dq_bf16_kernel<64>"),
    (_ANON.format("bwd") + "25flash_bwd_dkv_bf16_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff",
     "flash_bwd_dkv_bf16_kernel<128>"),
    (_ANON.format("bwd") + "24flash_bwd_dkv_f32_kernelILi32EEEvPKfS2_S2_S2_S2_S2_PfS3_iiff",
     "flash_bwd_dkv_f32_kernel<32>"),
    ("_Z12other_kernelPf", "_Z12other_kernelPf"),
])
def test_chip_smoke_names_the_flash_kernels_in_sass(mangled, name):
    """The build phase counts HGMMA per kernel under these names; every bf16 forward, dQ and dK/dV
    kernel must be recognised (the backward's two-part names included)."""
    assert _chip_smoke().kernel_name(mangled) == name


@pytest.mark.parametrize("seen, expect", [
    ({"k": (20, 200.0)}, ({"k": 1}, 0.01)),
    # the first 3 events of kind "a" and 1 of "b" missed: each kind at its mean, times its number a call
    ({"a": (17, 170.0), "b": (39, 78.0)}, ({"a": 1, "b": 2}, 0.014)),
    ({"k": (10, 100.0)}, None),  # half missed: 1 a call, or 2 with three quarters missed
    ({"a": (20, 200.0), "b": (30, 60.0)}, None),
    ({}, None),
])
def test_chip_smoke_reads_a_profiler_window(seen, expect):
    """Device time per call from a window of 20 calls whose first events the tracer may have missed."""
    got = _chip_smoke().window_ms(seen, 20)
    assert got == expect if expect is None else (got[0] == expect[0] and got[1] == pytest.approx(expect[1]))


@pytest.mark.parametrize("traces, shortfall", [
    ([1450], [0]),
    ([1440], [10]),  # within TRACE_MISS: kept
    ([1000, 1450], [450, 0]),  # a dropped block: traced again
    ([1000, 900, 1100], [450, 550, 350]),  # short in every trace: the caller's check fails
    ([1451], [-1]),  # more records than launches: not traced again
])
def test_chip_smoke_retraces_a_trace_short_of_records(traces, shortfall):
    """``traced`` takes a run's trace again, TRACE_TRIES times at most, while the trace holds fewer records
    than expected (less TRACE_MISS of them), and reports each trace's shortfall."""
    smoke = _chip_smoke()
    runs = []

    def profile_chain(torch, run, chain_ms=None):
        runs.append(run())
        return run, {"kernel_events": {"group_norm_silu": traces[len(runs) - 1]}}

    smoke.profile_chain = profile_chain
    out, prof = smoke.traced(None, lambda: "run", None, lambda prof: {"group_norm_silu": 1450})
    assert smoke.TRACE_TRIES == 3 and len(runs) == len(traces)
    assert prof["trace_shortfall"] == [{"group_norm_silu": n} for n in shortfall]


def _sweep_variants():
    from mrisr_torch.tools import flash_bwd_sweep, flash_fwd_sweep

    return [(source, name, edits) for source, tool in (("flash_attn_fwd", flash_fwd_sweep),
                                                      ("flash_attn_bwd", flash_bwd_sweep))
            for name, edits in tool.VARIANTS.items()]


@pytest.mark.parametrize("source, name, edits", _sweep_variants(), ids=lambda x: x if isinstance(x, str) else "")
def test_sweep_variants_apply_to_the_sources(source, name, edits):
    """Every design variant of the two sweeps finds its anchors in the checked-in sources (the kernel's
    own, or a header it includes) and changes them."""
    from mrisr_torch.tools.flash_fwd_sweep import variant_sources

    csrc = REPO / "mrisr_torch" / "csrc"
    out = variant_sources(csrc, source, edits, name)
    assert sorted(out) == sorted({e[0] if len(e) == 3 else f"{source}.cu" for e in edits})
    assert all(text != (csrc / file).read_text() for file, text in out.items())


def test_sweep_anchors_match_on_code_tokens():
    from mrisr_torch.tools.flash_fwd_sweep import apply_edits

    src = "  static constexpr int kKeys=128;   // keys a tile\n  int x = kKeys;\n"
    assert apply_edits(src, [("kKeys = 128;", "kKeys = 64;")]) == (
        "  static constexpr int kKeys = 64;   // keys a tile\n  int x = kKeys;\n")
    with pytest.raises(RuntimeError, match="anchor not in the source"):
        apply_edits(src, [("kKeys = 256;", "kKeys = 64;")], "v")


# ---------------------------------------------------------------------------
# The fp32 backward kernels' arithmetic (3xTF32), emulated on the CPU
# ---------------------------------------------------------------------------


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the tensor cores read it (13 low mantissa bits dropped; ``tools/tf32_probe.py``)."""
    return (x.contiguous().view(torch.int32) & t_flash.TF32_MASK).view(torch.float32).double()


def _product(a_hi, a_lo, b_hi, b_lo, passes=3):
    """``sum_k a[b, i, k] b[b, j, k]`` as the kernels' tf32 products take it: lo hi + hi lo + hi hi
    (lo lo dropped), or hi hi alone with ``passes=1``; each operand as the tensor cores read it, sums
    in float64 (the kernels add each tile's product to an fp32 sum)."""
    out = _tf32_read(a_hi) @ _tf32_read(b_hi).transpose(1, 2)
    if passes == 3:
        out = out + _tf32_read(a_lo) @ _tf32_read(b_hi).transpose(1, 2) + _tf32_read(a_hi) @ _tf32_read(
            b_lo).transpose(1, 2)
    return out.float()


def _split(x):
    return t_flash.tf32_hi(x), t_flash.tf32_lo(x)


def _tf32_backward_emulated(q, k, v, lse, do, scale, passes=3):
    """``(dq, dk, dv)`` as the fp32 kernels compute them: every product from ``tf32_parts`` (the owned
    and walked tiles) or split in registers (P, dS), the second-stage products over the permuted index
    order of the transposed copies (``transpose_permuted``: a thread's accumulator columns 2t, 2t+1
    are its A fragment's k t, t+4), exp2 with log2(e) folded in.  Keys and queries past the end are
    zero rows of the padded copies."""
    parts = t_flash.tf32_parts(q, k, v, do)
    delta = (do * t_flash.flash_attention_plain(q, k, v, scale)[0]).sum(-1)
    log2e = 1.4426950408889634
    s = _product(parts["q_hi"], parts["q_lo"], parts["k_hi"], parts["k_lo"], passes)
    dp = _product(parts["do_hi"], parts["do_lo"], parts["v_hi"], parts["v_lo"], passes)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    ds = p * (dp - delta[..., None])
    # B2a: A = dS (queries x keys) with the keys permuted as in K^T.
    ds_perm = t_flash.transpose_permuted(ds.transpose(1, 2))
    dq = _product(*_split(ds_perm), parts["kt"], parts["kt_lo"], passes) * scale
    # B2b: A = P^T, dS^T (keys x queries) with the queries permuted as in dO^T, Q^T.
    dv = _product(*_split(t_flash.transpose_permuted(p)), parts["dot"], parts["dot_lo"], passes)
    dk = _product(*_split(t_flash.transpose_permuted(ds)), parts["qt"], parts["qt_lo"], passes) * scale
    return dq, dk, dv


def _within(got, want, tol):
    """``chip_smoke.py``'s backward check: every element within atol_rms * rms(ref) + rtol * |ref|,
    rms(err) within rms_rel * rms(ref).  Returns (worst element / its limit, rms(err) / rms(ref))."""
    rms_ref = float(want.square().mean().sqrt())
    err = (got - want).abs()
    worst = float((err / (tol["atol_rms"] * rms_ref + tol["rtol"] * want.abs())).max())
    return worst, float(err.square().mean().sqrt()) / rms_ref


@pytest.mark.parametrize("b,n,m,d,extreme", [
    pytest.param(2, 256, 256, 32, False, id="2-256-256-32"),
    pytest.param(2, 128, 192, 64, False, id="2-128-192-64"),
    pytest.param(2, 37, 5, 32, False, id="ragged-2-37-5-32"),
    pytest.param(2, 130, 70, 128, False, id="ragged-2-130-70-128"),
    pytest.param(2, 100, 60, 64, True, id="extreme-2-100-60-64"),
    # SD1.5's 40-wide heads: dK/dV at D = 40 (dV, dK at N = 40); dQ on its parts padded to 64 adds zeros only
    pytest.param(2, 130, 70, 40, False, id="ragged-2-130-70-40"),
    pytest.param(2, 130, 70, 40, True, id="extreme-2-130-70-40"),
])
def test_tf32_backward_emulation_meets_the_fp32_limits_against_jax(b, n, m, d, extreme):
    """The fp32 kernels' arithmetic (3xTF32 with the tensor cores' truncation, lo lo dropped, the permuted
    second-stage order) against JAX's fp32 backward (the Pallas dq/dkv kernels in interpret mode) at the
    unchanged ``FLASH_BWD_TOL["float32"]``.  ``extreme``: every score below -100."""
    rng = np.random.default_rng(30 + n + m + d)
    q, k, v, g = (rng.standard_normal((b, s, d)).astype(np.float32) for s in (n, m, m, n))
    scale = 1.0 / np.sqrt(d)
    if extreme:
        q, k = (t.numpy() for t in _chip_smoke().extreme_qk(torch.from_numpy(q), torch.from_numpy(k)))
        assert (np.einsum("bnd,bmd->bnm", q, k) * scale).max() < -100.0
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = _flash_fwd_impl(jq, jk, jv, scale, max(n, m), max(n, m), interpret=True)
    want = _flash_backward(jq, jk, jv, out, lse, jg, scale, max(n, m), interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = _tf32_backward_emulated(*args, torch.from_numpy(np.array(lse)[:, 0]), torch.from_numpy(g), scale)
    tol = _chip_smoke().FLASH_BWD_TOL["float32"]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        worst, rms_rel = _within(a, torch.from_numpy(np.array(w)), tol)
        assert worst <= 1.0 and rms_rel <= tol["rms_rel"], (name, worst, rms_rel)


def test_one_tf32_pass_falls_short_of_the_fp32_limits():
    """Why three passes: the hi hi product alone (1xTF32) misses ``FLASH_BWD_TOL["float32"]``."""
    rng = np.random.default_rng(31)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 256, 32)).astype(np.float32)) for _ in range(4))
    scale = 1.0 / np.sqrt(32)
    _, lse = t_flash.flash_attention_plain(q, k, v, scale)
    want = t_flash.flash_attention_bwd_plain(q, k, v, t_flash.flash_attention_plain(q, k, v, scale)[0], lse, g,
                                             scale)
    tol = _chip_smoke().FLASH_BWD_TOL["float32"]
    three = _tf32_backward_emulated(q, k, v, lse, g, scale)
    one = _tf32_backward_emulated(q, k, v, lse, g, scale, passes=1)
    for a, w in zip(three, want):
        assert _within(a, w, tol)[1] <= tol["rms_rel"]
    assert all(_within(a, w, tol)[1] > tol["rms_rel"] for a, w in zip(one, want))


def _tf32_np(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to tf32 to nearest, ties away from zero, in numpy."""
    return ((x.view(np.int32).astype(np.int64) + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("n,m,d", [(64, 128, 32), (37, 5, 32), (130, 70, 128), (1, 333, 64)])
def test_tf32_parts_match_numpy(n, m, d):
    """The prep's plain version: hi/lo split, transpose, zero pad to a multiple of 64, permutation."""
    rng = np.random.default_rng(32)
    arrays = {name: (rng.standard_normal((2, s, d)) * 2.0 ** rng.integers(-4, 5, (2, s, d))).astype(np.float32)
              for name, s in (("q", n), ("k", m), ("v", m), ("do", n))}
    parts = t_flash.tf32_parts(*(torch.from_numpy(arrays[x]) for x in ("q", "k", "v", "do")))
    assert tuple(parts) == t_flash.TF32_PARTS
    for name, x in arrays.items():
        hi = _tf32_np(x)
        lo = _tf32_np(x - hi)
        np.testing.assert_array_equal(parts[f"{name}_hi"].numpy(), hi)
        np.testing.assert_array_equal(parts[f"{name}_lo"].numpy(), lo)
        assert np.abs(x - hi - lo).max() <= 2.0**-21 * np.abs(x).max()
        if name == "v":
            continue
        rows = x.shape[1]
        for suffix, src in (("t", hi), ("t_lo", lo)):
            got = parts[f"{name}{suffix}"].numpy()
            want = np.zeros((2, d, -(-rows // 64) * 64), np.float32)
            for r in range(rows):
                g8, rest = divmod(r, 8)
                want[:, :, 8 * g8 + 4 * (rest % 2) + rest // 2] = src[:, r, :]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m", [(130, 70), (37, 5)])
def test_dq_parts_of_40_wide_heads_are_read_at_their_own_width(n, m):
    """B2a takes a 40-wide fp32 head as it is: ``tf32_parts`` of 40-wide inputs are the parts it reads
    (``DQ_PARTS``) at q's own width, and the C interface gets null for the transposed Q and dO."""
    rng = np.random.default_rng(33)
    q, k, v, do = (torch.from_numpy((rng.standard_normal((2, s, 40)) * 2.0 ** rng.integers(-4, 5, (2, s, 40)))
                                    .astype(np.float32)) for s in (n, m, m, n))
    parts = t_flash.tf32_parts(q, k, v, do)
    t_flash._check_parts(q, k, parts, t_flash.DQ_PARTS)
    assert tuple(parts["kt"].shape) == (2, 40, -(-m // t_flash.TRANSPOSE_PAD) * t_flash.TRANSPOSE_PAD)
    ptrs, kept = t_flash._parts_arg(q, k, v, do, parts, t_flash.DQ_PARTS)
    assert kept is parts
    assert [ptrs[t_flash.TF32_PARTS.index(x)] for x in ("qt", "qt_lo", "dot", "dot_lo")] == [None] * 4
    assert all(ptrs[t_flash.TF32_PARTS.index(x)] == parts[x].data_ptr() for x in t_flash.DQ_PARTS)
    wide = {name: t_flash._pad_head_dim(t, 64) if name not in ("kt", "kt_lo") else t for name, t in parts.items()}
    with pytest.raises(ValueError, match="part q_hi"):
        t_flash._check_parts(q, k, wide, t_flash.DQ_PARTS)  # parts padded to 64: not q's width


def test_parts_arg_passes_null_for_parts_the_kernel_does_not_read():
    """The C interface's ``parts``: every pointer in ``TF32_PARTS`` order, null where the kernel reads no such
    part (dQ: the transposed Q and dO; dK/dV: the transposed K)."""
    q = torch.zeros(1, 8, 40)
    parts = t_flash.tf32_parts(q, q, q, q)
    for names in (t_flash.DQ_PARTS, t_flash.DKV_PARTS, t_flash.TF32_PARTS):
        ptrs, kept = t_flash._parts_arg(q, q, q, q, parts, names)
        assert kept is parts and len(ptrs) == len(t_flash.TF32_PARTS)
        assert list(ptrs) == [parts[x].data_ptr() if x in names else None for x in t_flash.TF32_PARTS]
    assert set(t_flash.TF32_PARTS) - set(t_flash.DQ_PARTS) == {"qt", "qt_lo", "dot", "dot_lo"}
    assert set(t_flash.TF32_PARTS) - set(t_flash.DKV_PARTS) == {"kt", "kt_lo"}


def _f32_parts(n=8, m=8, d=32, **bad):
    q, k = torch.zeros(1, n, d), torch.zeros(1, m, d)
    return q, k, t_flash.tf32_parts(q, k, k, q) | bad


@pytest.mark.parametrize("case, bad, error, match", [
    ("missing", lambda p: {n: t for n, t in p.items() if n != "kt_lo"}, ValueError, "take the parts"),
    ("wrong_shape", lambda p: p | {"qt": torch.zeros(1, 32, 8)}, ValueError, "part qt"),
    ("bf16_part", lambda p: p | {"k_lo": p["k_lo"].to(torch.bfloat16)}, TypeError, "part k_lo"),
    ("strided", lambda p: p | {"do_hi": torch.zeros(1, 32, 8).transpose(1, 2)}, ValueError, "contiguous do_hi"),
    ("misaligned", lambda p: p | {"v_hi": _misaligned((1, 8, 32), torch.float32)}, ValueError,
     "16-byte aligned v_hi"),
])
def test_fp32_kernel_parts_are_checked(case, bad, error, match):
    """The fp32 kernels' ``parts`` argument: every part, of its shape, float32, contiguous and aligned."""
    q, k, parts = _f32_parts()
    t_flash._check_parts(q, k, parts)
    with pytest.raises(error, match=match):
        t_flash._check_parts(q, k, bad(parts))


def test_fp32_kernel_parts_are_for_fp32_only():
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="take the parts"):
        t_flash._check_parts(q, q, None)
    qb = q.to(torch.bfloat16)
    t_flash._check_parts(qb, qb, None)
    with pytest.raises(ValueError, match="float32 inputs only"):
        t_flash._check_parts(qb, qb, _f32_parts()[2])


def test_transpose_pad_matches_the_kernel_source():
    """The transposed copies' row length is rounded up to the same multiple on both sides."""
    src = (REPO / "mrisr_torch" / "csrc" / "flash_attn_bwd.cu").read_text()
    assert f"constexpr int kTransposePad = {t_flash.TRANSPOSE_PAD};" in src
    names = src[src.index("enum Part {"):].split("}")[0]
    assert len(names.split(",")) == len(t_flash.TF32_PARTS)


def test_bf16_forward_kernel_takes_positive_scale_only():
    """The bf16 kernel folds the scale into a row max of raw scores, so it must be > 0."""
    q = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
    for scale in (0.0, -0.5, float("nan")):
        with pytest.raises(ValueError, match="scale > 0"):
            t_flash._launch(q, q, q, scale)


# ---------------------------------------------------------------------------
# Hygiene
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mrisr_tpu")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax():
    files = sorted((REPO / "mrisr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    assert len(files) > 25 and {"mrisr_torch/train/steps.py", "mrisr_torch/train/state.py",
                                "mrisr_torch/utils/checkpoint.py", "mrisr_torch/diffusion/sr3.py"} <= names
    latent = {f"mrisr_torch/models/{m}.py" for m in ("sd_layers", "sd_unet", "controlnet", "vae", "adapter", "lora",
                                                     "tokenizer", "clip_text", "convert")}
    assert latent | {"mrisr_torch/diffusion/res_shift.py", "mrisr_torch/pipelines/latent.py"} <= names
    cli = {"mrisr_torch/cli.py", "mrisr_torch/config.py", "mrisr_torch/ops/resize.py", "mrisr_torch/train/validation.py",
           "mrisr_torch/utils/logging.py", "mrisr_torch/utils/profiling.py"}
    data = {f"mrisr_torch/data/{m}.py" for m in ("degrade", "dicom", "datasets", "loader", "slicecache")}
    assert cli | data <= names
    for path in files:
        bad = _imports(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    from mrisr_torch import _build, ops
    from mrisr_torch.models.resdiff_unet import ResDiffUNet
    from mrisr_torch.models.simple_cnn import SimpleCNN
    from mrisr_torch.pipelines.resdiff import ResDiffPipeline
    from mrisr_torch.train import state as t_state
    from mrisr_torch.train import steps as t_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(image_size=16, inner_channel=8, norm_groups=4)
    for make in (lambda: ResDiffUNet(**small), SimpleCNN, ops.build_kernels,
                 lambda: _build.load_library("flash_attn_fwd"), lambda: _build.load_library("flash_attn_bwd")):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    unet, cnn = ResDiffUNet(**small, device="cpu"), SimpleCNN(device="cpu")
    sched = t_sched.resdiff_schedule(100)
    for make in (lambda: t_state.create_train_state(unet, t_state.make_optimizer()),
                 lambda: t_steps.make_resdiff_train_step(unet, sched),
                 lambda: t_steps.make_resdiff_train_many(unet, sched),
                 lambda: t_steps.make_cnn_train_step(cnn),
                 lambda: t_steps.make_cnn_train_many(cnn)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    state = t_state.create_train_state(unet, t_state.make_optimizer(), device="cpu")
    assert next(iter(state.params.values())).device.type == "cpu"
    t_steps.make_resdiff_train_step(unet, sched, device="cpu")
    assert unet.training  # the trainer turns dropout on; the pipeline below turns it off again
    with pytest.raises(RuntimeError, match="is_available"):
        ResDiffPipeline(cnn, unet, t_sched.resdiff_schedule(1000))
    pipe = ResDiffPipeline(cnn, unet, t_sched.resdiff_schedule(1000), device="cpu")
    assert next(pipe.unet.parameters()).device.type == "cpu" and not pipe.unet.training

    # the latent family
    from mrisr_torch.models.adapter import T2IAdapter
    from mrisr_torch.models.clip_text import CLIPTextEncoder
    from mrisr_torch.models.controlnet import ControlNet
    from mrisr_torch.models.sd_unet import SDUNet
    from mrisr_torch.models.vae import AutoencoderKL
    from mrisr_torch.pipelines.latent import LatentSRPipeline

    sd = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
    makers = {"unet": lambda **kw: SDUNet(**sd, **kw), "controlnet": lambda **kw: ControlNet(**sd, **kw),
              "vae": lambda **kw: AutoencoderKL((8, 8, 16, 16), **kw),
              "adapter": lambda **kw: T2IAdapter((8, 16, 16, 16), **kw),
              "clip": lambda **kw: CLIPTextEncoder(100, 16, 1, 2, 32, 16, 99, **kw)}
    for make in makers.values():
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    cpu = {name: make(device="cpu") for name, make in makers.items()}
    assert all(next(m.parameters()).device.type == "cpu" for m in cpu.values())
    args = (cpu["unet"], cpu["controlnet"], cpu["vae"], t_sched.sd15_schedule(), torch.zeros(1, 7, 16))
    with pytest.raises(RuntimeError, match="is_available"):
        LatentSRPipeline(*args)
    latent = LatentSRPipeline(*args, adapter=cpu["adapter"], device="cpu")
    assert latent.mode == "adapter" and not latent.cuda_graph
