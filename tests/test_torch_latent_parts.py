"""The port's latent family's parts against the JAX package, on the CPU.

Res-SRDiff steps and chain, LoRA, the checkpoint converters, CLIP text and
the tokenizers, and ``mrisr_torch.bench --pipeline latent --device cpu``.
Inputs and Flax parameters come from numpy with a fixed seed; the JAX
package's random draws are reproduced from its key splits and handed to the
port as tensors.  float32 throughout; tolerances as stated at each test.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.diffusion import res_shift as j_rs
from mrisr_tpu.diffusion import schedules as j_sched
from mrisr_tpu.models import clip_text as j_clip
from mrisr_tpu.models import controlnet as j_cn
from mrisr_tpu.models import convert as j_convert
from mrisr_tpu.models import lora as j_lora
from mrisr_tpu.models import sd_unet as j_unet
from mrisr_tpu.models import tokenizer as j_tok
from mrisr_tpu.models import vae as j_vae
from mrisr_tpu.pipelines import sampler as j_sampler
from mrisr_torch.diffusion import res_shift as t_rs
from mrisr_torch.diffusion import schedules as t_sched
from mrisr_torch.models import clip_text as t_clip
from mrisr_torch.models import controlnet as t_cn
from mrisr_torch.models import convert as t_convert
from mrisr_torch.models import lora as t_lora
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import tokenizer as t_tok
from mrisr_torch.models import vae as t_vae
from mrisr_torch.pipelines import sampler as t_sampler
from mrisr_torch.weights import load_flax_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TOL = dict(atol=2e-4, rtol=1e-3)
TINY = dict(block_out_channels=(8, 16, 16, 16), heads=2, context_dim=16)
TINY_VAE = (8, 8, 16, 16)


def flax_random_params(module, args, seed=0, **kw):
    """Kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases and embeddings ~ 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("bias", "embedding", "position_embedding"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(int(np.prod(s.shape[:-1])))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _x(*shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# Res-SRDiff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
def test_res_shift_steps(prediction_type):
    js, ts = j_sched.sd15_schedule(), t_sched.sd15_schedule()
    hr, lr, eps, x_t = (_x(3, 4, 8, 8, seed=s) for s in (1, 2, 3, 4))
    t = np.array([950, 500, 1], np.int32)
    t_prev = np.array([900, 0, 0], np.int32)
    np.testing.assert_allclose(
        t_rs.shift_forward(ts, *map(torch.from_numpy, (hr, lr)), torch.from_numpy(t).long(), torch.from_numpy(eps)),
        j_rs.shift_forward(js, *map(jnp.asarray, (hr, lr, t, eps))), **TOL)
    np.testing.assert_allclose(
        t_rs.predict_x0(ts, *map(torch.from_numpy, (x_t, lr)), torch.from_numpy(t).long(), torch.from_numpy(eps)),
        j_rs.predict_x0(js, *map(jnp.asarray, (x_t, lr, t, eps))), **TOL)
    key = jax.random.PRNGKey(7)
    want = j_rs.shift_reverse_step(js, *map(jnp.asarray, (x_t, lr, t, t_prev, eps)), key,
                                   prediction_type=prediction_type)
    noise = torch.from_numpy(np.array(jax.random.normal(key, x_t.shape, jnp.float32)))
    got = t_rs.shift_reverse_step(ts, torch.from_numpy(x_t), torch.from_numpy(lr), torch.from_numpy(t).long(),
                                  torch.from_numpy(t_prev).long(), torch.from_numpy(eps), noise, prediction_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # t_prev = 0 adds no noise; t_prev > 0 does
    zero = t_rs.shift_reverse_step(ts, torch.from_numpy(x_t), torch.from_numpy(lr), torch.from_numpy(t).long(),
                                   torch.from_numpy(t_prev).long(), torch.from_numpy(eps), 0 * noise, prediction_type)
    assert torch.equal(got[1:], zero[1:]) and not torch.equal(got[0], zero[0])
    bf16 = t_rs.shift_reverse_step(ts, torch.from_numpy(x_t).bfloat16(), torch.from_numpy(lr),
                                   torch.from_numpy(t).long(), torch.from_numpy(t_prev).long(),
                                   torch.from_numpy(eps), noise, prediction_type)
    assert bf16.dtype == torch.bfloat16


def _jax_chain_noise(key, shape, steps):
    """The draws ``mrisr_tpu.pipelines.sampler.res_shift_sample`` makes from ``key`` (NHWC ``shape``):
    the start from the second half of the first split, then one split per step."""
    key, k0 = jax.random.split(key)
    start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    step = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        step.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return start, np.stack(step)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
def test_res_shift_sample(prediction_type):
    """The chain over ``leading`` timesteps, t_prev clamped to 0 on the last step, with a simple eps_fn."""
    js, ts = j_sched.sd15_schedule(), t_sched.sd15_schedule()
    anchor = _x(2, 8, 8, 4, seed=5)
    steps = 5
    key = jax.random.PRNGKey(11)
    want = j_sampler.res_shift_sample(js, lambda x, t: 0.3 * x + t[:, None, None, None] / 1000.0,
                                      jnp.asarray(anchor), key, steps, prediction_type=prediction_type)
    start, step = _jax_chain_noise(key, anchor.shape, steps)
    got = t_sampler.res_shift_sample(
        ts, lambda x, t: 0.3 * x + t[:, None, None, None] / 1000.0, nchw(anchor), nchw(start),
        torch.from_numpy(np.ascontiguousarray(step.transpose(0, 1, 4, 2, 3))), steps,
        prediction_type=prediction_type)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), **TOL)
    # the generator path draws the start, then each step's noise
    gen_a, gen_b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    drawn = t_sampler.res_shift_sample(ts, lambda x, t: 0.3 * x, nchw(anchor), num_steps=steps, generator=gen_a)
    z0 = torch.randn(nchw(anchor).shape, generator=gen_b)
    zs = torch.randn((steps, *nchw(anchor).shape), generator=gen_b)
    given = t_sampler.res_shift_sample(ts, lambda x, t: 0.3 * x, nchw(anchor), z0, zs, steps)
    assert torch.equal(drawn, given)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def _tiny_unet_pair(seed=8):
    x, t, ctx = jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))
    junet = j_unet.SDUNet(**TINY)
    params = flax_random_params(junet, (x, t, ctx), seed=seed)
    tunet = t_unet.SDUNet(**TINY, device="cpu")
    load_flax_params(tunet, params)
    return junet, params, tunet


def test_lora_init_apply_merge():
    _, params, tunet = _tiny_unet_pair()
    jl = j_lora.init_lora_params(jax.random.PRNGKey(0), params, rank=2)
    # nonzero b, so the merge is not zero
    rng = np.random.default_rng(4)
    jl = {path: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape).astype(np.float32))}
          for path, ab in jl.items()}
    want = j_lora.merge_lora(params, jl, alpha=3.0)
    lora = {path[1:]: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()} for path, ab in jl.items()}

    fresh = t_lora.init_lora_params(tunet, rank=2, generator=torch.Generator().manual_seed(0))
    assert set(fresh) == set(lora) and len(lora) == 4 * 2 * 16  # 4 projections x 2 attentions x 16 Transformer2Ds
    assert t_lora.count_lora_params(fresh) == j_lora.count_lora_params(jl)
    for path, ab in fresh.items():
        assert ab["a"].shape == lora[path]["a"].shape and float(ab["b"].abs().max()) == 0.0

    merged = t_lora.apply_lora_delta(tunet, lora, alpha=3.0)
    ref = t_unet.SDUNet(**TINY, device="cpu")
    load_flax_params(ref, want)
    ref_params = dict(ref.named_parameters())
    moved = 0
    for name, p in merged.items():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name].detach().numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
        moved += not torch.equal(p, dict(tunet.named_parameters())[name])
    assert moved == len(lora)
    t_lora.merge_lora(tunet, lora, alpha=3.0)
    for name, p in tunet.named_parameters():
        assert torch.equal(p, merged[name]), name


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def _convert_case(which):
    if which == "unet":
        junet = j_unet.SDUNet(**TINY)
        params = flax_random_params(junet, (jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))))
        mk = lambda: t_unet.SDUNet(**TINY, device="cpu")  # noqa: E731
        return params, mk(), t_convert.convert_sd_unet, mk()
    if which == "controlnet":
        jcn = j_cn.ControlNet(**TINY)
        params = flax_random_params(jcn, (jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 7, 16)),
                                          jnp.zeros((1, 64, 64, 3))))
        mk = lambda: t_cn.ControlNet(**TINY, device="cpu")  # noqa: E731
        return params, mk(), t_convert.convert_controlnet, mk()
    jvae = j_vae.AutoencoderKL(block_out_channels=TINY_VAE)
    params = flax_random_params(jvae, (jnp.zeros((1, 32, 32, 3)),))
    mk = lambda: t_vae.AutoencoderKL(TINY_VAE, device="cpu")  # noqa: E731
    return params, mk(), t_convert.convert_vae, mk()


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae", "vae_legacy"])
def test_convert_round_trip(which):
    """JAX params -> ``export_diffusers_tree`` (the reference's diffusers key scheme) -> the port's converter:
    equal to ``load_flax_params`` and filling every parameter (strict load)."""
    params, by_tree, convert, by_convert = _convert_case(which.split("_")[0])
    load_flax_params(by_tree, params)
    sd = j_convert.export_diffusers_tree(params)
    if which == "vae_legacy":  # pre-0.15 diffusers: query/key/value/proj_attn as 1x1 convs
        ren = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        legacy = {}
        for k, w in sd.items():
            for new, old in ren.items():
                if "attentions.0." in k and f".{new}." in k:
                    k, w = k.replace(f".{new}.", f".{old}."), (w[:, :, None, None] if w.ndim == 2 else w)
                    break
            legacy[k] = w
        sd = legacy
    state = convert(sd)
    by_convert.load_state_dict(state, strict=True)
    want = dict(by_tree.named_parameters())
    assert set(state) == set(want)
    for name, p in by_convert.named_parameters():
        assert torch.equal(p, want[name]), name


# ---------------------------------------------------------------------------
# CLIP text and the tokenizers
# ---------------------------------------------------------------------------

CLIP = dict(vocab_size=100, hidden=32, layers=2, heads=4, intermediate=64, max_positions=16, eos_token_id=99)


def test_clip_text_and_fixed_prompt():
    """A transformers CLIPTextModel's state dict through both packages' converters: equal hidden states and
    pooled outputs (and the transformers model's own); ``get_fixed_prompt_embeds`` with HashTokenizer."""
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=16, eos_token_id=99, bos_token_id=98)
    torch.manual_seed(0)
    tm = CLIPTextModel(cfg).eval()
    sd = tm.state_dict()
    jenc = j_clip.CLIPTextEncoder(**CLIP)
    jparams = j_convert.convert_clip_text(sd, num_layers=2)
    tenc = t_clip.CLIPTextEncoder(**CLIP, device="cpu")
    tenc.load_state_dict(t_convert.convert_clip_text(sd, num_layers=2), strict=True)
    tree = t_clip.CLIPTextEncoder(**CLIP, device="cpu")
    load_flax_params(tree, jparams)  # LayerNorm, Embed and the module-level position_embedding
    for name, p in tree.named_parameters():
        assert torch.equal(p, dict(tenc.named_parameters())[name]), name
    ids = np.array([[98, 5, 7, 99, 99, 99, 99, 99], [98, 3, 4, 5, 6, 99, 99, 99]], np.int32)
    jh, jp = jenc.apply(jparams, jnp.asarray(ids))
    with torch.no_grad():
        th, tp = tenc(torch.from_numpy(ids))
        ref = tm(torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), ref.last_hidden_state.numpy(), atol=2e-5, rtol=1e-5)

    big = dict(CLIP, vocab_size=49408, max_positions=77, eos_token_id=49407)
    jenc77 = j_clip.CLIPTextEncoder(**big)
    params = flax_random_params(jenc77, (jnp.zeros((1, 77), jnp.int32),), seed=3)
    tenc77 = t_clip.CLIPTextEncoder(**big, device="cpu")
    load_flax_params(tenc77, params)
    tok = j_clip.HashTokenizer()
    want = j_clip.get_fixed_prompt_embeds(jenc77, params, tok, "a brain mri")
    got = t_clip.get_fixed_prompt_embeds(tenc77, t_clip.HashTokenizer(), "a brain mri")
    assert tuple(got.shape) == (1, 77, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_tokenizer_ids():
    prompts = ["medical mri scan, high resolution", "T1-weighted brain 3T", "  Axial   FLAIR!! "]
    words = ["medical", "mri", "scan", "high", "resolution", "brain", "axial", "flair"]
    vocab, merges = j_tok.build_mini_vocab(words)
    assert t_tok.build_mini_vocab(words) == (vocab, merges)
    jt, tt = j_tok.CLIPBPETokenizer(vocab, merges), t_tok.CLIPBPETokenizer(vocab, merges)
    for p in prompts:
        for kw in ({}, {"max_length": 8}, {"padding": "none"}):
            a, b = jt(p, **kw), tt(p, **kw)
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        assert jt.decode(jt(p)["input_ids"]) == tt.decode(tt(p)["input_ids"])
    np.testing.assert_array_equal(j_clip.HashTokenizer()(prompts)["input_ids"],
                                  t_clip.HashTokenizer()(prompts)["input_ids"])
    assert isinstance(t_clip.default_tokenizer(), t_clip.HashTokenizer)



def test_bench_latent_on_cpu(capsys):
    """The bench's entry point end to end on the CPU at the JAX bench's cpu_smoke sizes (not a device number)."""
    from mrisr_torch import bench

    assert bench.main(["--pipeline", "latent", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "slices/sec/gpu" and line["device"] == "cpu" and line["value"] > 0
    assert "Latent SR" in line["metric"] and line["cuda_graph"] is False
