"""SDXL's text towers and prompt utilities (``mrisr_torch/models/sdxl_text.py``) against the JAX package's,
on the CPU, at the JAX tests' tiny widths (ViT-L-like tower 16 wide, bigG-like 24 wide with a 20-wide
projection, 3 layers, 16 tokens), on one set of numpy-drawn weights: the projection tower and
``encode_prompt_sdxl`` within atol 1e-5; the penultimate state, the time ids and the CFG dropout's share;
and a ``clip-proj`` tree from ``convert-weights`` (a checkpoint under transformers'
``CLIPTextModelWithProjection`` names) loading into the projection tower bitwise.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.models import clip_text as j_clip
from mrisr_tpu.models import sdxl_text as j_sdxl
from mrisr_torch import cli
from mrisr_torch.models import clip_text as t_clip
from mrisr_torch.models import sdxl_text as t_sdxl
from mrisr_torch.weights import load_flax_params, load_params_npz
from test_torch_latent_pipeline import flax_random_params
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TINY1 = dict(vocab_size=100, hidden=16, layers=3, heads=2, intermediate=32, max_positions=16, eos_token_id=99)
TINY2 = dict(vocab_size=100, hidden=24, layers=3, heads=2, intermediate=48, max_positions=16, eos_token_id=99,
             projection_dim=20)
PROMPTS = ["a scan", "another axial slice"]


class TinyTok(t_clip.HashTokenizer):
    model_max_length = 16

    def __init__(self):
        super().__init__(vocab_size=100)
        self.bos_token_id, self.eos_token_id = 98, 99


@pytest.fixture(scope="module")
def towers():
    ids = jnp.zeros((1, 16), jnp.int32)
    j = (j_clip.CLIPTextEncoder(**TINY1), j_sdxl.CLIPTextEncoderWithProjection(**TINY2))
    params = (flax_random_params(j[0], (ids,), seed=1), flax_random_params(j[1], (ids,), seed=2))
    t = (t_clip.CLIPTextEncoder(**TINY1, device="cpu"), t_sdxl.CLIPTextEncoderWithProjection(**TINY2, device="cpu"))
    for module, tree in zip(t, params):
        load_flax_params(module, tree)
    return dict(j=j, params=params, t=t, toks=(TinyTok(), TinyTok()))


def test_projection_tower_and_encode_prompt_match_jax(towers):
    """The projection tower's hidden state, projected pooled output and hidden states, and
    ``encode_prompt_sdxl``'s concatenated penultimate states and pooled output, against JAX's."""
    j, params, t, toks = towers["j"], towers["params"], towers["t"], towers["toks"]
    ids = np.asarray(toks[1](PROMPTS)["input_ids"])
    jh, jp, js = j[1].apply(params[1], jnp.asarray(ids), output_hidden_states=True)
    with torch.no_grad():
        th, tp, ts = t[1](torch.from_numpy(ids), output_hidden_states=True)
    for a, b in [(th, jh), (tp, jp)] + list(zip(ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    want_e, want_p = j_sdxl.encode_prompt_sdxl(j, params, toks, PROMPTS)
    got_e, got_p = t_sdxl.encode_prompt_sdxl(t, toks, PROMPTS)
    assert tuple(got_e.shape) == (2, 16, 16 + 24) and tuple(got_p.shape) == (2, 20)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    want_h = j_sdxl.encode_prompt_sd1x5(j[0], params[0], toks[0], PROMPTS)
    np.testing.assert_allclose(t_sdxl.encode_prompt_sd1x5(t[0], toks[0], PROMPTS).numpy(), np.asarray(want_h),
                               atol=1e-5)


def test_penultimate_state_time_ids_and_dropout(towers):
    """The prompt embedding is each tower's ``hidden_states[-2]`` (bitwise); ``compute_embeddings_sdxl``'s
    time ids; the CFG dropout drops about its share and nothing without a generator, at 0 or in eval."""
    t, toks = towers["t"], towers["toks"]
    ids = torch.from_numpy(np.asarray(toks[0](PROMPTS)["input_ids"]))
    with torch.no_grad():
        _, _, states = t[0](ids, output_hidden_states=True)
    embeds, _ = t_sdxl.encode_prompt_sdxl(t, toks, PROMPTS)
    assert torch.equal(embeds[..., :16], states[-2])
    out = t_sdxl.compute_embeddings_sdxl(t, toks, ["x"], original_size=(512, 512), crops_coords_top_left=(1, 2),
                                         target_size=(256, 256))
    assert set(out) == {"prompt_embeds", "text_embeds", "time_ids"}
    assert out["time_ids"].tolist() == [[512, 512, 1, 2, 256, 256]]
    assert t_sdxl.make_add_time_ids((64, 64), (0, 0), (32, 32), batch=3).shape == (3, 6)
    np.testing.assert_array_equal(t_sdxl.make_add_time_ids((64, 64), (0, 0), (32, 32), batch=3).numpy(),
                                  np.asarray(j_sdxl.make_add_time_ids((64, 64), (0, 0), (32, 32), batch=3)))
    prompts = ["p"] * 2000
    gen = torch.Generator().manual_seed(0)
    dropped = t_sdxl.maybe_drop_prompts(prompts, gen, proportion_empty_prompts=0.1)
    assert 0.07 < sum(p == "" for p in dropped) / len(dropped) < 0.13
    assert t_sdxl.maybe_drop_prompts(prompts, None, 0.5) == prompts
    assert t_sdxl.maybe_drop_prompts(prompts, gen, 0.0) == prompts
    assert t_sdxl.maybe_drop_prompts(prompts, gen, 0.5, is_train=False) == prompts


def _transformers_names(tower) -> dict:
    """The tower's weights under transformers' ``CLIPTextModelWithProjection`` names (the checkpoint layout
    ``convert-weights`` reads)."""
    out = {}
    for k, v in tower.state_dict().items():
        k = k.replace("text_model.layers_", "text_model.encoder.layers.")
        k = k.replace("text_model.token_embedding.", "text_model.embeddings.token_embedding.")
        k = k.replace("text_model.position_embedding", "text_model.embeddings.position_embedding.weight")
        out[k] = v.numpy()
    return out


def test_clip_proj_tree_from_convert_weights_loads(towers, tmp_path):
    """The projection tower saved under transformers' names as ``.safetensors``, converted by
    ``convert-weights --model clip-proj``, loads into a fresh tower that gives the same hidden states and
    projected pooled output, bitwise (the reference's own test pins its tower to transformers')."""
    from mrisr_torch.data.safetensors_io import save_safetensors

    tower, toks = towers["t"][1], towers["toks"]
    save_safetensors(tmp_path / "clip.safetensors", _transformers_names(tower))
    cli.run(["convert-weights", "--model", "clip-proj", "--num-layers", str(TINY2["layers"]), "--input",
             str(tmp_path / "clip.safetensors"), "--output", str(tmp_path / "clip.npz")])
    ours = t_sdxl.CLIPTextEncoderWithProjection(**TINY2, device="cpu")
    load_flax_params(ours, load_params_npz(tmp_path / "clip.npz"))
    ids = torch.from_numpy(np.asarray(toks[1](PROMPTS)["input_ids"]))
    with torch.no_grad():
        want, got = tower(ids, output_hidden_states=True), ours(ids, output_hidden_states=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
