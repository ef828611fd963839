"""The port's training slice against the JAX reference, on the CPU.

Inputs and weights come from numpy with a fixed seed and go through both
packages; Flax parameter (and gradient) trees are carried across by
``mrisr_torch.weights.load_flax_params``.  Everything is float32 unless a
test says otherwise.  The UNet is the tiny one of ``tests/test_train_many.py``
(16^2, inner 8, GroupNorm(4)); JAX runs with ``dropout=0.0`` and its random
draws (``t``, ``gamma``, ``eps``) are reproduced outside its step and injected
into the port's through ``draws``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrisr_tpu.diffusion import sr3 as j_sr3
from mrisr_tpu.diffusion.schedules import resdiff_schedule as j_resdiff_schedule
from mrisr_tpu.models.resdiff_unet import ResDiffUNet as JUNet
from mrisr_tpu.models.simple_cnn import SimpleCNN as JCNN
from mrisr_tpu.ops.attention import dense_attention as j_dense_attention
from mrisr_tpu.ops.flash_attention import _flash_backward, _flash_fwd_impl
from mrisr_tpu.train import losses as j_losses
from mrisr_tpu.train import state as j_state
from mrisr_tpu.train import steps as j_steps
from mrisr_torch.diffusion import sr3 as t_sr3
from mrisr_torch.diffusion.schedules import resdiff_schedule as t_resdiff_schedule
from mrisr_torch.models import layers as tl
from mrisr_torch.models.resdiff_unet import ResDiffUNet as TUNet
from mrisr_torch.models.simple_cnn import SimpleCNN as TCNN
from mrisr_torch.ops import attention as t_attn
from mrisr_torch.ops import flash_attention as t_flash
from mrisr_torch.ops import groupnorm as t_gn
from mrisr_torch.train import losses as t_losses
from mrisr_torch.train import state as t_state
from mrisr_torch.train import steps as t_steps
from mrisr_torch.train.precision import Policy, get_policy
from mrisr_torch.utils.checkpoint import CheckpointManager
from mrisr_torch.weights import load_flax_params
from test_torch_ops import _chip_smoke
from test_torch_resdiff import flax_random_params, to_torch

TINY = dict(image_size=16, inner_channel=8, norm_groups=4)
T = 100
LR = 2e-4


def _x(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _u(*shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _torch_named(tmod, tree) -> dict[str, np.ndarray]:
    """A Flax tree (parameters or gradients) as the port's ``{name: array}``, in the port's layout."""
    load_flax_params(tmod, tree)
    return {k: p.detach().numpy().copy() for k, p in tmod.named_parameters()}


def _recorder():
    """An optimizer that keeps the gradients it is given and moves nothing."""
    seen = {}

    def update(grads, opt_state, params):
        seen.update(grads)
        return {k: torch.zeros_like(g) for k, g in grads.items()}, opt_state

    return t_state.Optimizer(lambda params: {}, update), seen


# ---------------------------------------------------------------------------
# Kernel modules: the plain backward, and the two autograd functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,d,block,extreme", [
    pytest.param(256, 256, 32, 128, False, id="256-256-32-128"),
    pytest.param(512, 512, 16, 256, False, id="512-512-16-256"),
    pytest.param(256, 128, 32, 128, False, id="256-128-32-128"),
    pytest.param(256, 128, 32, 128, True, id="256-128-32-128-extreme"),
])
def test_flash_bwd_plain_matches_jax_kernels_and_dense_vjp(n, m, d, block, extreme):
    """B2's plain version against the Pallas dq/dkv kernels (interpret mode) and ``jax.vjp``.

    atol 5e-4 is the bar ``tests/test_flash_attention.py`` holds the Pallas
    kernels to (float32 sums over up to 512 keys in different orders).
    ``extreme``: q and k built as ``chip_smoke.py``'s extreme-score cases
    build them, so that every score is below -100 (where a zero key past M
    would overflow exp(-lse) in a kernel that did not mask it).
    """
    q, k, v, g = (_x(2, s, d, seed=10 + i) for i, s in enumerate((n, m, m, n)))
    scale = 1.0 / np.sqrt(d)
    if extreme:
        q, k = (t.numpy() for t in _chip_smoke().extreme_qk(torch.from_numpy(q), torch.from_numpy(k)))
        assert (np.einsum("bnd,bmd->bnm", q, k) * scale).max() < -100.0
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = _flash_fwd_impl(jq, jk, jv, scale, block, block, interpret=True)
    kern = _flash_backward(jq, jk, jv, out, lse, jg, scale, block, interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: j_dense_attention(a, b, c, scale), jq, jk, jv)
    dense = vjp(jg)

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    to, tlse = t_flash.flash_attention_fwd(tq, tk, tv, scale)
    got = t_flash.flash_attention_bwd(tq, tk, tv, to, tlse, tg, scale)
    for name, a, w_kern, w_dense in zip(("dq", "dk", "dv"), got, kern, dense):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w_kern), atol=5e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(w_dense), atol=5e-4, err_msg=name)
    assert t_flash.flash_attention_bwd_dq.launches == t_flash.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("n,m,d,dtype", [(640, 640, 32, torch.float32), (1300, 70, 16, torch.float32),
                                         (512, 512, 64, torch.bfloat16)])
def test_flash_attention_gradients_match_dense_autograd(n, m, d, dtype):
    """Gradients through the ``flash_attention`` function equal autograd through ``dense_attention``.

    (1300, 70) is ragged: the last q chunk of the plain backward is short.
    bf16 inputs: both sides compute in fp32 and round the gradients to bf16
    (2^-8 relative).
    """
    q, k, v, g = (torch.from_numpy(_x(2, s, d, seed=20 + i)).to(dtype) for i, s in enumerate((n, m, m, n)))
    scale = 1.0 / np.sqrt(d)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = t_flash.flash_attention(*a, scale)
    ref = t_attn.dense_attention(*(t.float() for t in b), scale)
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref, **tol)
    for ga, gb in zip(torch.autograd.grad(out, a, g), torch.autograd.grad(ref, b, g.float())):
        assert ga.dtype == dtype
        torch.testing.assert_close(ga.float(), gb.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_function_gradients_match_torch(monkeypatch, dtype):
    """The autograd function of B3 (kernel forward, composition backward) against F.group_norm + F.silu.

    The Triton launch is stood in for by the plain version, so that the
    function's own backward runs here; the CPU path of the wrapper is held to
    the same gradients.
    """
    monkeypatch.setattr(t_gn, "_launch", t_gn.group_norm_silu_plain)
    x = torch.from_numpy(_x(2, 8, 6, 5, seed=30) * 2 + 0.5).to(dtype)
    w = torch.from_numpy(1 + 0.2 * _x(8, seed=31)).to(dtype)
    b = torch.from_numpy(0.1 * _x(8, seed=32)).to(dtype)
    dy = torch.from_numpy(_x(2, 8, 6, 5, seed=33)).to(dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        return torch.autograd.grad(fn(*leaves), leaves, dy)

    want = grads(lambda x_, w_, b_: F.silu(F.group_norm(x_.float(), 4, w_.float(), b_.float(), 1e-5)).to(dtype))
    before = t_gn.group_norm_silu.launches
    via_function = grads(lambda x_, w_, b_: t_gn._GroupNormSiLU.apply(x_, w_, b_, 4, 1e-5))
    assert t_gn.group_norm_silu.launches == before + 1
    via_wrapper = grads(lambda x_, w_, b_: t_gn.group_norm_silu(x_, w_, b_, 4, 1e-5))
    for got in (via_function, via_wrapper):
        for g, w_ in zip(got, want):
            assert g.dtype == dtype
            torch.testing.assert_close(g, w_, atol=1e-6, rtol=1e-5)
    # Only the input's gradient asked for: the others come back as None.
    x_only = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(t_gn._GroupNormSiLU.apply(x_only, w, b, 4, 1e-5), x_only, dy)
    torch.testing.assert_close(gx, want[0], atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# sr3 and the losses
# ---------------------------------------------------------------------------


def test_sr3_functions_match_jax():
    sj, st = j_resdiff_schedule(T), t_resdiff_schedule(T)
    t = np.array([0, 1, 57, 99])
    x0, eps = _x(4, 8, 8, 1, seed=40), _x(4, 8, 8, 1, seed=41)
    gamma = np.array([0.999, 0.9, 0.5, 0.05], np.float32)
    want = j_sr3.q_sample_gamma(jnp.asarray(x0), jnp.asarray(gamma), jnp.asarray(eps))
    got = t_sr3.q_sample_gamma(to_torch(x0), torch.from_numpy(gamma), to_torch(eps))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-6, atol=1e-7)
    back_j = j_sr3.predict_x0_from_eps_gamma(want, jnp.asarray(gamma), jnp.asarray(eps))
    back_t = t_sr3.predict_x0_from_eps_gamma(got, torch.from_numpy(gamma), to_torch(eps))
    np.testing.assert_allclose(back_t.numpy().transpose(0, 2, 3, 1), np.asarray(back_j), rtol=1e-5, atol=1e-5)
    # gamma = lo + (hi - lo) u: the bounds are the schedule's, the draw the generator's.
    lo, hi = np.sqrt(np.asarray(sj.alphas_cumprod)[t]), np.sqrt(np.asarray(sj.alphas_cumprod_prev)[t])
    g1 = t_sr3.sample_gamma(st, torch.from_numpy(t), torch.Generator().manual_seed(0))
    g2 = t_sr3.sample_gamma(st, torch.from_numpy(t), torch.Generator().manual_seed(0))
    u = torch.rand(4, generator=torch.Generator().manual_seed(0)).numpy()
    assert torch.equal(g1, g2)
    np.testing.assert_allclose(g1.numpy(), lo + (hi - lo) * u, rtol=1e-6)
    assert hi[0] == 1.0 and np.all(g1.numpy() >= lo) and np.all(g1.numpy() <= hi)


@pytest.mark.parametrize("name", ["l2", "l1", "frequency_l1", "image_compare_loss"])
def test_losses_match_jax(name):
    pred, target = _x(2, 12, 16, 1, seed=42), _x(2, 12, 16, 1, seed=43)
    want = getattr(j_losses, name)(jnp.asarray(pred), jnp.asarray(target))
    got = getattr(t_losses, name)(to_torch(pred), to_torch(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizer, EMA and schedules against optax, on injected gradients
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adam": dict(),
    "adamw": dict(kind="adamw", weight_decay=0.05),
    "max_grad_norm": dict(max_grad_norm=0.5),
    "grad_accum_with_ema": dict(grad_accum=2),
    "skip_nonfinite": dict(skip_nonfinite=True, max_grad_norm=1.0),
    "cosine_schedule": dict(kind="adamw", weight_decay=0.01, grad_accum=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_and_ema_match_optax(case):
    """Five calls with the same numpy gradients: params, EMA and step to rtol 1e-6.

    ``grad_accum=2`` moves the parameters on calls 2 and 4 only, while step and
    EMA move on every call; ``skip_nonfinite`` sees a NaN gradient on call 3
    and leaves parameters and Adam moments as they were.
    """
    kw = OPT_CASES[case]
    if case == "cosine_schedule":
        lr_j = j_state.make_lr_schedule("cosine", 1e-2, warmup_steps=2, total_steps=6)
        lr_t = t_state.make_lr_schedule("cosine", 1e-2, warmup_steps=2, total_steps=6)
    else:
        lr_j = lr_t = 1e-2
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: _x(*s, seed=50 + i) for i, (k, s) in enumerate(shapes.items())}
    js = j_state.create_train_state(None, {k: jnp.asarray(v) for k, v in p0.items()},
                                    j_state.make_optimizer(lr_j, **kw), ema_decay=0.9)
    ts = t_state.TrainState({k: torch.from_numpy(v.copy()) for k, v in p0.items()},
                            tx := t_state.make_optimizer(lr_t, **kw), None, 0,
                            {k: torch.from_numpy(v.copy()) for k, v in p0.items()}, 0.9)
    ts.opt_state = tx.init(ts.params)
    for call in range(5):
        g = {k: _x(*s, seed=60 + 10 * call + i) for i, (k, s) in enumerate(shapes.items())}
        if case == "skip_nonfinite" and call == 2:
            g["b"][1] = np.nan
        before = {k: v.clone() for k, v in ts.params.items()}
        js = js.apply_gradients(grads={k: jnp.asarray(v) for k, v in g.items()})
        ts = ts.apply_gradients({k: torch.from_numpy(v) for k, v in g.items()})
        assert ts.step == int(js.step) == call + 1
        for k in shapes:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.ema_params[k].numpy(), np.asarray(js.ema_params[k]), rtol=1e-6, atol=1e-7)
        unchanged = all(torch.equal(ts.params[k], before[k]) for k in shapes)
        if case == "grad_accum_with_ema":
            assert unchanged == (call % 2 == 0)
        elif case == "cosine_schedule":  # the warmup starts at lr 0, so the first emitted update is zero too
            assert unchanged == (call != 3)
        elif case == "skip_nonfinite":
            assert unchanged == (call == 2)
        else:
            assert not unchanged


@pytest.mark.parametrize("name,warmup,total", [("constant", 0, 10), ("constant", 4, 10), ("cosine", 3, 12),
                                               ("cosine", 0, 1), ("linear", 3, 12), ("linear", 0, 5)])
def test_lr_schedule_matches_optax(name, warmup, total):
    sj = j_state.make_lr_schedule(name, 3e-4, warmup, total)
    st = t_state.make_lr_schedule(name, 3e-4, warmup, total)
    for step in (0, 1, 2, 3, 4, 7, 11, 12, 40):
        np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


def test_unported_optimizer_and_unknown_names_raise():
    with pytest.raises(NotImplementedError, match="adafactor"):
        t_state.make_optimizer(kind="adafactor")
    with pytest.raises(ValueError):
        t_state.make_optimizer(kind="sgd")
    with pytest.raises(ValueError):
        t_state.make_lr_schedule("exponential")
    with pytest.raises(ValueError):
        get_policy("fp8")
    assert get_policy("bf16") == get_policy("mixed") == Policy(compute_dtype=torch.bfloat16)
    assert get_policy(None) == get_policy("fp32") == Policy()


# ---------------------------------------------------------------------------
# The tiny UNet: gradients and the three-step trajectory against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The JAX UNet (dropout 0), its numpy-drawn parameters and one numpy batch."""
    ju = JUNet(**TINY, dropout=0.0, s2d_level0=False)
    b = 4
    init = (jnp.zeros((b, 16, 16, 2)), jnp.full((b,), 0.5))
    params = flax_random_params(ju, init, seed=70)
    return dict(ju=ju, params=params, sr=_u(b, 16, 16, 1, seed=71), hr=_u(b, 16, 16, 1, seed=72))


def _torch_unet(params, **kw):
    tu = TUNet(**TINY, device="cpu", **kw)
    load_flax_params(tu, params)
    return tu


def test_tiny_unet_loss_gradients_match_jax_grad(tiny):
    """Per parameter leaf, relative L2 <= 1e-4 (float32 sums in different orders through ~60 layers)."""
    ju, params, sr, hr = tiny["ju"], tiny["params"], tiny["sr"], tiny["hr"]
    gamma = np.array([0.95, 0.7, 0.4, 0.1], np.float32)
    eps = _x(4, 16, 16, 1, seed=73)

    def j_loss(p):
        x_t = j_sr3.q_sample_gamma(jnp.asarray(hr - sr), jnp.asarray(gamma), jnp.asarray(eps))
        pred = ju.apply(p, jnp.concatenate([jnp.asarray(sr), x_t], axis=-1), jnp.asarray(gamma))
        return j_losses.l2(pred, jnp.asarray(eps))

    want_loss, want = jax.jit(jax.value_and_grad(j_loss))(params)
    tu = _torch_unet(params, dropout=0.0)
    tx, seen = _recorder()
    step = t_steps.make_resdiff_train_step(tu, t_resdiff_schedule(T), device="cpu")
    state = t_state.create_train_state(tu, tx, device="cpu")
    _, metrics = step(state, {"sr": torch.from_numpy(sr), "hr": torch.from_numpy(hr)}, None,
                      {"gamma": torch.from_numpy(gamma), "eps": to_torch(eps)})
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    want_named = _torch_named(TUNet(**TINY, device="cpu"), want)
    assert set(seen) == set(want_named) and len(seen) > 100
    for name, w in want_named.items():
        # (A leaf whose gradient is exactly zero on both sides passes with rel 0.)
        rel = np.linalg.norm(seen[name].numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (name, rel)


def _assert_params_track(got: dict, want: dict, lr: float, steps: int, loose_max: int):
    """Parameters after a few Adam steps against the reference's.

    Adam's first steps move every element by about ``lr * sign(g)``, so an
    element whose gradient is ~0 may land up to ``2 * lr`` a step apart.  All
    elements are within ``2 * lr * steps``; all but ``loose_max`` of them
    within 2 % of one step.
    """
    loose = 0
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w)
        assert diff.max() <= 2 * lr * steps, name
        loose += int((diff > 0.02 * lr).sum())
    assert loose <= loose_max, loose


def test_resdiff_three_step_trajectory_matches_jax(tiny):
    ju, params, sr, hr = tiny["ju"], tiny["params"], tiny["sr"], tiny["hr"]
    sj = j_resdiff_schedule(T)
    js = j_state.create_train_state(ju.apply, params, j_state.make_optimizer(LR), ema_decay=0.99)
    j_step = j_steps.make_resdiff_train_step(ju, sj)
    tu = _torch_unet(params, dropout=0.0)
    t_step = t_steps.make_resdiff_train_step(tu, t_resdiff_schedule(T), device="cpu")
    ts = t_state.create_train_state(tu, t_state.make_optimizer(LR), ema_decay=0.99, device="cpu")
    batch_t = {"sr": torch.from_numpy(sr), "hr": torch.from_numpy(hr)}
    key = jax.random.PRNGKey(7)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        # The step's own draws (mrisr_tpu/train/steps.py), reproduced outside it.
        k_t, k_g, k_eps, _ = jax.random.split(k, 4)
        t = jax.random.randint(k_t, (4,), 0, sj.num_timesteps)
        gamma = j_sr3.sample_gamma(sj, t, k_g)
        eps = jax.random.normal(k_eps, hr.shape, jnp.float32)
        js, jm = j_step(js, {"sr": jnp.asarray(sr), "hr": jnp.asarray(hr)}, k)
        ts, tm = t_step(ts, batch_t, None, {"gamma": torch.from_numpy(np.array(gamma)),
                                            "eps": to_torch(np.array(eps))})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, err_msg=f"step {i}")
    assert ts.step == int(js.step) == 3
    scratch = TUNet(**TINY, device="cpu")
    n_params = sum(p.numel() for p in ts.params.values())
    _assert_params_track(ts.params, _torch_named(scratch, js.params), LR, 3, loose_max=n_params // 1000)
    _assert_params_track(ts.ema_params, _torch_named(scratch, js.ema_params), LR, 3, loose_max=0)


def test_cnn_three_step_trajectory_matches_jax():
    jc = JCNN(hidden=8)
    lr_img, hr = _u(4, 16, 16, 1, seed=80), _u(4, 16, 16, 1, seed=81)
    params = flax_random_params(jc, (jnp.asarray(lr_img),), seed=82)
    js = j_state.create_train_state(jc.apply, params, j_state.make_optimizer(1e-3))
    j_step = j_steps.make_cnn_train_step(jc)
    tc = TCNN(hidden=8, device="cpu")
    load_flax_params(tc, params)
    t_step = t_steps.make_cnn_train_step(tc, device="cpu")
    ts = t_state.create_train_state(tc, t_state.make_optimizer(1e-3), device="cpu")
    for i in range(3):
        js, jm = j_step(js, {"lr": jnp.asarray(lr_img), "hr": jnp.asarray(hr)}, jax.random.PRNGKey(i))
        ts, tm = t_step(ts, {"lr": torch.from_numpy(lr_img), "hr": torch.from_numpy(hr)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, err_msg=f"step {i}")
    assert ts.ema_params is None and js.ema_params is None
    n_params = sum(p.numel() for p in ts.params.values())
    _assert_params_track(ts.params, _torch_named(TCNN(hidden=8, device="cpu"), js.params), 1e-3, 3,
                         loose_max=n_params // 1000)


# ---------------------------------------------------------------------------
# Dropout, remat, *_many, the precision policy, checkpoints
# ---------------------------------------------------------------------------


def test_dropout_acts_in_training_mode_only_and_follows_its_generator():
    block = tl.ConvBlock(8, 8, 4, dropout=0.5)
    with torch.no_grad():
        block.Conv_0.weight.zero_()
        block.Conv_0.weight[:, :, 1, 1] = torch.eye(8)  # the conv passes its input through
        block.Conv_0.bias.zero_()
        x = torch.from_numpy(_x(2, 8, 32, 32, seed=90))
        plain = t_gn.group_norm_silu_plain(x, block.GroupNorm_0.weight, block.GroupNorm_0.bias, 4)
        block.eval()
        torch.testing.assert_close(block(x), plain)  # identity in eval mode, and no generator needed
        block.train()
        with pytest.raises(ValueError, match="Generator"):
            block(x)
        a = block(x, torch.Generator().manual_seed(1))
        b = block(x, torch.Generator().manual_seed(1))
        c = block(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.02  # 16384 draws at rate 0.5: sigma 0.004
    torch.testing.assert_close(a[kept], (plain / 0.5)[kept])
    # Only the second ConvBlock of a ResnetBlock drops, as in the reference.
    res = tl.ResnetBlock(8, 8, 4, 16, dropout=0.3)
    assert (res.ConvBlock_0.dropout, res.ConvBlock_1.dropout) == (0.0, 0.3)
    unet = TUNet(**TINY, device="cpu")
    assert not unet.training and unet.ResnetBlockWithAttn_0.ResnetBlock_0.ConvBlock_1.dropout == 0.2
    assert unet.final_conv.dropout == 0.0


@pytest.fixture(scope="module")
def dropout_run():
    """The tiny UNet with dropout 0.2, a small training set and a stepper factory."""
    torch.manual_seed(0)
    unet = TUNet(**TINY, device="cpu")
    sched = t_resdiff_schedule(T)
    sr_all, hr_all = torch.from_numpy(_u(10, 16, 16, 1, seed=91)), torch.from_numpy(_u(10, 16, 16, 1, seed=92))

    def fresh_state(tx=None):
        return t_state.create_train_state(unet, tx or t_state.make_optimizer(LR), ema_decay=0.99, device="cpu")

    return dict(unet=unet, sched=sched, sr_all=sr_all, hr_all=hr_all, fresh_state=fresh_state)


def test_remat_gives_the_same_loss_and_gradients_with_dropout(dropout_run):
    unet, sched = dropout_run["unet"], dropout_run["sched"]
    batch = {"sr": dropout_run["sr_all"][:4], "hr": dropout_run["hr_all"][:4]}
    results = []
    for remat in (False, True):
        tx, seen = _recorder()
        step = t_steps.make_resdiff_train_step(unet, sched, remat=remat, device="cpu")
        assert unet.training
        gen = t_steps.step_generator(3, 0, "cpu")
        _, metrics = step(dropout_run["fresh_state"](tx), batch, gen)
        results.append((float(metrics["loss"]), dict(seen), gen.get_state()))
    (loss_a, grads_a, gen_a), (loss_b, grads_b, gen_b) = results
    assert loss_a == loss_b and torch.equal(gen_a, gen_b)
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, atol=1e-7, rtol=1e-5, msg=name)
    # The masks matter: another generator gives another loss.
    tx, _ = _recorder()
    step = t_steps.make_resdiff_train_step(unet, sched, device="cpu")
    _, other = step(dropout_run["fresh_state"](tx), batch, t_steps.step_generator(3, 1, "cpu"))
    assert float(other["loss"]) != loss_a


def test_resdiff_train_many_equals_the_loop(dropout_run):
    unet, sched, sr_all, hr_all = (dropout_run[k] for k in ("unet", "sched", "sr_all", "hr_all"))
    idx = np.stack([np.random.default_rng(100 + i).integers(0, 10, 4) for i in range(3)])
    step = t_steps.make_resdiff_train_step(unet, sched, device="cpu")
    state_a, losses = dropout_run["fresh_state"](), []
    for i in range(3):
        ix = torch.from_numpy(idx[i])
        state_a, m = step(state_a, {"sr": sr_all[ix], "hr": hr_all[ix]}, t_steps.step_generator(5, i, "cpu"))
        losses.append(m["loss"])
    many = t_steps.make_resdiff_train_many(unet, sched, device="cpu")
    state_b, losses_b = many(dropout_run["fresh_state"](), sr_all, hr_all, idx, range(3), 5)
    assert torch.equal(torch.stack(losses), losses_b) and state_b.step == 3
    for name, p in state_a.params.items():
        assert torch.equal(state_b.params[name], p) and torch.equal(state_b.ema_params[name], state_a.ema_params[name])


def test_cnn_train_many_equals_the_loop():
    torch.manual_seed(1)
    cnn = TCNN(hidden=8, device="cpu")
    lr_all, hr_all = torch.from_numpy(_u(12, 16, 16, 1, seed=93)), torch.from_numpy(_u(12, 16, 16, 1, seed=94))
    idx = np.stack([np.random.default_rng(i).integers(0, 12, 4) for i in range(4)])
    step = t_steps.make_cnn_train_step(cnn, device="cpu")
    state_a = t_state.create_train_state(cnn, t_state.make_optimizer(1e-3), device="cpu")
    losses = []
    for i in range(4):
        ix = torch.from_numpy(idx[i])
        state_a, m = step(state_a, {"lr": lr_all[ix], "hr": hr_all[ix]})
        losses.append(m["loss"])
    many = t_steps.make_cnn_train_many(cnn, device="cpu")
    state_b, losses_b = many(t_state.create_train_state(cnn, t_state.make_optimizer(1e-3), device="cpu"),
                             lr_all, hr_all, idx)
    assert torch.equal(torch.stack(losses), losses_b) and float(losses_b[-1]) < float(losses_b[0])
    for name, p in state_a.params.items():
        assert torch.equal(state_b.params[name], p)


def test_bf16_policy_keeps_fp32_masters_and_runs_the_forward_in_bf16(dropout_run):
    unet, sched = dropout_run["unet"], dropout_run["sched"]
    batch = {"sr": dropout_run["sr_all"][:2], "hr": dropout_run["hr_all"][:2]}
    seen_dtypes = []
    hook = unet.conv_in.register_forward_hook(lambda mod, args, out: seen_dtypes.append((args[0].dtype, out.dtype)))
    try:
        tx, grads = _recorder()
        step = t_steps.make_resdiff_train_step(unet, sched, get_policy("bfloat16"), device="cpu")
        state, metrics = step(dropout_run["fresh_state"](tx), batch, t_steps.step_generator(1, 0, "cpu"))
        tx32, grads32 = _recorder()
        step32 = t_steps.make_resdiff_train_step(unet, sched, device="cpu")
        _, metrics32 = step32(dropout_run["fresh_state"](tx32), batch, t_steps.step_generator(1, 0, "cpu"))
    finally:
        hook.remove()
    assert seen_dtypes == [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]
    assert metrics["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(g.dtype == torch.float32 for g in grads.values()) and set(grads) == set(state.params)
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    # bf16 compute tracks fp32 loosely (2^-8 relative per op through the network).
    np.testing.assert_allclose(float(metrics["loss"]), float(metrics32["loss"]), rtol=2e-2)
    cos = F.cosine_similarity(grads["conv_in.weight"].flatten(), grads32["conv_in.weight"].flatten(), dim=0)
    assert float(cos) > 0.9


def test_checkpoint_manager_round_trip(tmp_path, dropout_run):
    unet, sched = dropout_run["unet"], dropout_run["sched"]
    batch = {"sr": dropout_run["sr_all"][:2], "hr": dropout_run["hr_all"][:2]}
    tx = t_state.make_optimizer(LR, grad_accum=2, skip_nonfinite=True, max_grad_norm=1.0)
    step = t_steps.make_resdiff_train_step(unet, sched, device="cpu")
    state = dropout_run["fresh_state"](tx)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    saved = {}
    for i in range(3):
        state, _ = step(state, batch, t_steps.step_generator(2, i, "cpu"))
        assert mgr.save(state.step, state)
        saved[state.step] = state
    assert not mgr.save(3, state) and mgr.save(3, state, force=True)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3  # max_to_keep dropped step 1

    template = dropout_run["fresh_state"](tx)
    for which, step_no in ((None, 3), (2, 2)):
        back = mgr.restore(template, which)
        want = saved[step_no]
        assert back.step == step_no and back.ema_decay == want.ema_decay and back.tx is tx
        for name, p in want.params.items():
            assert torch.equal(back.params[name], p) and torch.equal(back.ema_params[name], want.ema_params[name])
        flat = lambda tree: [tree] if not isinstance(tree, dict) else [x for v in tree.values() for x in flat(v)]  # noqa: E731
        for a, b in zip(flat(back.opt_state), flat(want.opt_state), strict=True):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    # A restored state trains on exactly as the one that was saved.
    gen = t_steps.step_generator(2, 3, "cpu")
    next_a, ma = step(saved[3], batch, gen)
    next_b, mb = step(mgr.restore(template), batch, t_steps.step_generator(2, 3, "cpu"))
    assert float(ma["loss"]) == float(mb["loss"])
    assert all(torch.equal(next_b.params[k], p) for k, p in next_a.params.items())
    mgr.close()
    # The names are the module's own: a state's parameters (or EMA) load straight into one.
    other = TUNet(**TINY, device="cpu")
    other.load_state_dict(next_a.ema_params)
    assert all(torch.equal(p, next_a.ema_params[k]) for k, p in other.named_parameters())
