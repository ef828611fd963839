"""Weights across the packages on the CPU: ``.safetensors`` and torch checkpoints, ``convert-weights`` for each
of its five models, ``export_diffusers_tree`` and ``weights.flax_params``, ``train-latent --weights-dir`` on
what the port wrote, and ``train-latent``'s flags that it parses and does not act on.

Every ``.npz`` the port writes is held to the JAX package's array for array: the same keys, dtypes and values,
exactly.  Inputs are random from numpy seeds.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mrisr_tpu import cli as j_cli
from mrisr_tpu.data import safetensors_io as j_st
from mrisr_tpu.models import convert as j_convert
from mrisr_torch import cli as t_cli
from mrisr_torch.data import safetensors_io as t_st
from mrisr_torch.models import convert as t_convert
from mrisr_torch.models import sd_unet as t_unet
from mrisr_torch.models import vae as t_vae
from mrisr_torch.weights import flax_params, load_flax_params, load_params_npz, sd_unet_shape
from test_torch_cli import _assert_trees_equal, _ckpt
from test_torch_latent_parts import _convert_case
from test_torch_ops import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _tensors(seed=0) -> dict:
    """One tensor of each dtype the format names, and a BF16 one (as its raw bits) apart."""
    rng = np.random.default_rng(seed)
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "f64": rng.standard_normal(4),
            "f16": rng.standard_normal((2, 2)).astype(np.float16),
            "i64": rng.integers(-9, 9, (7,)), "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
            "i16": rng.integers(-9, 9, (5,)).astype(np.int16), "i8": rng.integers(-9, 9, (4,)).astype(np.int8),
            "u8": rng.integers(0, 255, (6,)).astype(np.uint8), "bool": rng.random((3,)) > 0.5,
            "scalar": np.float32(1.5).reshape(()), "empty": np.zeros((0, 4), np.float32)}


def _bf16_file(path, bits: np.ndarray) -> None:
    """A ``.safetensors`` holding one BF16 tensor (neither writer writes BF16)."""
    import json

    header = json.dumps({"w": {"dtype": "BF16", "shape": list(bits.shape), "data_offsets": [0, bits.nbytes]},
                         "__metadata__": {"format": "pt"}}, separators=(",", ":")).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bits.tobytes())


def test_safetensors_cross_read_bytes_and_bf16(tmp_path):
    """A file written by either package reads the same in both (dtypes and values exact); the port's writer
    gives the JAX writer's bytes (metadata too); BF16 widens exactly (the raw bits on request)."""
    tensors = _tensors()
    j_st.save_safetensors(tmp_path / "j.safetensors", tensors, metadata={"step": 3})
    t_st.save_safetensors(tmp_path / "t.safetensors", tensors, metadata={"step": 3})
    assert (tmp_path / "t.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()
    for name in ("j", "t"):
        got = t_st.load_safetensors(tmp_path / f"{name}.safetensors")
        want = j_st.load_safetensors(tmp_path / f"{name}.safetensors")
        assert sorted(got) == sorted(want) == sorted(tensors)
        for k in tensors:
            want_k = np.atleast_1d(tensors[k])  # both writers store a 0-d array as shape [1]
            assert got[k].dtype == want[k].dtype == want_k.dtype and got[k].shape == want[k].shape == want_k.shape, k
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], want_k)
    odd = {"u32": np.arange(4, dtype=np.uint32)}  # a dtype the format table lacks: written as float32
    t_st.save_safetensors(tmp_path / "o1.safetensors", odd)
    j_st.save_safetensors(tmp_path / "o2.safetensors", odd)
    assert (tmp_path / "o1.safetensors").read_bytes() == (tmp_path / "o2.safetensors").read_bytes()

    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)
    _bf16_file(tmp_path / "bf.safetensors", bits)
    got, want = t_st.load_safetensors(tmp_path / "bf.safetensors"), j_st.load_safetensors(tmp_path / "bf.safetensors")
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["w"], torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(t_st.load_safetensors(tmp_path / "bf.safetensors", upcast_bf16=False)["w"], bits)


def test_torch_checkpoints_load_as_float32(tmp_path):
    """``.bin`` (a state dict) and ``.pt`` (a module) files: ``load_state_dict_any`` gives JAX's arrays (bf16
    widened to float32); a ``.safetensors`` goes through the native reader."""
    torch.manual_seed(0)
    sd = {"a.weight": torch.randn(3, 4), "a.bias": torch.randn(3).bfloat16(), "n": torch.arange(5)}
    torch.save(sd, tmp_path / "m.bin")
    got, want = t_st.load_state_dict_any(tmp_path / "m.bin"), j_st.load_state_dict_any(tmp_path / "m.bin")
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k])
    t_st.save_safetensors(tmp_path / "m.safetensors", {"x": np.ones(3, np.float32)})
    np.testing.assert_array_equal(t_st.load_state_dict_any(tmp_path / "m.safetensors")["x"], np.ones(3))


# ---------------------------------------------------------------------------
# convert-weights
# ---------------------------------------------------------------------------

CLIP_LAYERS, CLIP_HIDDEN = 2, 8


def _clip_state_dict(rng, prefix: str, proj: bool) -> dict:
    d, sd = CLIP_HIDDEN, {}
    p = prefix
    sd[f"{p}embeddings.token_embedding.weight"] = rng.standard_normal((11, d))
    sd[f"{p}embeddings.position_embedding.weight"] = rng.standard_normal((6, d))
    sd[f"{p}embeddings.position_ids"] = np.arange(6)[None]
    sd[f"{p}final_layer_norm.weight"], sd[f"{p}final_layer_norm.bias"] = rng.standard_normal((2, d))
    for i in range(CLIP_LAYERS):
        lp = f"{p}encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{lp}.{n}.weight"], sd[f"{lp}.{n}.bias"] = rng.standard_normal((2, d))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lp}.self_attn.{n}.weight"], sd[f"{lp}.self_attn.{n}.bias"] = (rng.standard_normal((d, d)),
                                                                               rng.standard_normal(d))
        sd[f"{lp}.mlp.fc1.weight"], sd[f"{lp}.mlp.fc1.bias"] = rng.standard_normal((2 * d, d)), rng.standard_normal(2 * d)
        sd[f"{lp}.mlp.fc2.weight"], sd[f"{lp}.mlp.fc2.bias"] = rng.standard_normal((d, 2 * d)), rng.standard_normal(d)
    if proj:
        sd["text_projection.weight"] = rng.standard_normal((d, d))
    return {k: np.asarray(v, np.float32) if v.dtype.kind == "f" else v for k, v in sd.items()}


def _legacy_vae(sd: dict) -> dict:
    """Pre-0.15 diffusers VAE attention names, projections stored as 1x1 convs."""
    ren = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    out = {}
    for k, w in sd.items():
        for new, old in ren.items():
            if "attentions.0." in k and f".{new}." in k:
                k, w = k.replace(f".{new}.", f".{old}."), (w[:, :, None, None] if w.ndim == 2 else w)
                break
        out[k] = w
    return out


def _state_dict(model: str) -> dict:
    """A diffusers / transformers state dict the test writes from random weights."""
    rng = np.random.default_rng(5)
    if model in ("clip", "clip-proj"):
        return _clip_state_dict(rng, "text_model." if model == "clip" else "", proj=model == "clip-proj")
    params = _convert_case(model)[0]
    sd = j_convert.export_diffusers_tree(params)
    return _legacy_vae(sd) if model == "vae" else sd


@pytest.mark.parametrize("model", ["vae", "unet", "controlnet", "clip", "clip-proj"])
def test_convert_weights_npz_equals_jax(model, tmp_path):
    """``convert-weights`` in both packages on the same ``.safetensors`` (and, for the UNet, the same torch
    ``.bin``): the port's ``.npz`` equals JAX's array for array (keys, dtypes and values exact)."""
    sd = _state_dict(model)
    src = tmp_path / "in.safetensors"
    t_st.save_safetensors(src, sd)
    inputs = [src]
    if model == "unet":
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tmp_path / "in.bin")
        inputs.append(tmp_path / "in.bin")
    extra = ["--num-layers", str(CLIP_LAYERS)] if model.startswith("clip") else []
    for i, path in enumerate(inputs):
        argv = ["convert-weights", "--model", model, "--input", str(path), *extra]
        res = t_cli.run([*argv, "--output", str(tmp_path / f"t{i}.npz")])
        assert j_cli.main([*argv, "--output", str(tmp_path / f"j{i}.npz")]) == 0
        assert res["tensors"] == len(sd)
        with np.load(tmp_path / f"t{i}.npz") as got, np.load(tmp_path / f"j{i}.npz") as want:
            assert got.files == want.files
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        tree = load_params_npz(tmp_path / f"t{i}.npz")
        assert t_convert.params_to_flat(tree).keys() == j_convert.params_to_flat(
            j_convert.load_params_npz(tmp_path / f"j{i}.npz")).keys()


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae"])
def test_export_diffusers_tree_equals_jax_on_carried_weights(which):
    """JAX params carried into a port module (``load_flax_params``): the port's ``export_diffusers_tree`` of
    the module equals JAX's of the params (keys, order and arrays exact); ``flax_params`` gives the tree
    back, and the Flax-layout converter inverts the export."""
    params, module, _, _ = _convert_case(which)
    load_flax_params(module, params)
    want = j_convert.export_diffusers_tree(params)
    got = t_convert.export_diffusers_tree(module)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert t_convert.params_to_flat(flax_params(module)).keys() == j_convert.params_to_flat(params["params"]).keys()
    for k, v in t_convert.params_to_flat(flax_params(module)).items():
        np.testing.assert_array_equal(v, np.asarray(j_convert.params_to_flat(params["params"])[k]), err_msg=k)
    conv = {"unet": t_convert.flax_sd_unet, "controlnet": t_convert.flax_controlnet, "vae": t_convert.flax_vae}[which]
    again = t_convert.params_to_flat(conv(got))
    for k, v in j_convert.params_to_flat(params).items():
        np.testing.assert_array_equal(again[k], np.asarray(v), err_msg=k)


def test_train_latent_reads_the_ports_converted_weights(tmp_path):
    """The tiny UNet and VAE exported (``export_diffusers_tree``) to ``.safetensors``, through the port's
    ``convert-weights`` to ``unet.npz`` / ``vae.npz``: ``train-latent --tiny --weights-dir`` starts from them,
    bitwise."""
    torch.manual_seed(3)
    cfg = t_cli.LATENT_TINY
    unet, vae = t_unet.SDUNet(**cfg["unet"], device="cpu"), t_vae.AutoencoderKL(**cfg["vae"], device="cpu")
    weights = tmp_path / "w"
    weights.mkdir()
    for name, module in (("unet", unet), ("vae", vae)):
        t_st.save_safetensors(tmp_path / f"{name}.safetensors", t_convert.export_diffusers_tree(module))
        t_cli.run(["convert-weights", "--model", name, "--input", str(tmp_path / f"{name}.safetensors"),
                   "--output", str(weights / f"{name}.npz")])
    res = t_cli.run(["train-latent", "--cpu", "--tiny", "--resolution", "64", "--batch", "1", "--steps", "0",
                     "--weights-dir", str(weights), "--out", str(tmp_path / "run")])
    for key, module in (("unet", unet), ("vae", vae)):
        loaded = dict(res[key].named_parameters())
        for name, p in module.named_parameters():
            assert torch.equal(loaded[name], p), f"{key}.{name}"


def test_train_latent_takes_the_unet_shape_of_its_npz(tmp_path):
    """A UNet cut to three levels and one ResnetBlock2D a down block, through ``convert-weights``:
    ``train-latent --tiny --weights-dir`` builds its UNet at that depth and width (``sd_unet_shape``), loads
    it bitwise and trains a ControlNet of the same shape."""
    torch.manual_seed(4)
    cut = dict(block_out_channels=(8, 16, 16), layers_per_block=1)
    unet = t_unet.SDUNet(**cut, heads=2, context_dim=16, device="cpu")
    weights = tmp_path / "w"
    weights.mkdir()
    t_st.save_safetensors(tmp_path / "unet.safetensors", t_convert.export_diffusers_tree(unet))
    t_cli.run(["convert-weights", "--model", "unet", "--input", str(tmp_path / "unet.safetensors"),
               "--output", str(weights / "unet.npz")])
    assert sd_unet_shape(load_params_npz(weights / "unet.npz")) == cut
    res = t_cli.run(["train-latent", "--cpu", "--tiny", "--resolution", "64", "--batch", "1", "--steps", "1",
                     "--weights-dir", str(weights), "--out", str(tmp_path / "run")])
    loaded = res["unet"]
    assert (loaded.block_out_channels, loaded.layers_per_block) == (cut["block_out_channels"], 1)
    mine = dict(unet.named_parameters())
    assert all(torch.equal(p, mine[k]) for k, p in loaded.named_parameters())
    assert any(k.startswith("down_blocks_2.") for k in res["state"].params)
    assert not any(k.startswith(("down_blocks_3.", "down_blocks_0.resnets_1.")) for k in res["state"].params)


TINY = ["--cpu", "--tiny", "--resolution", "64", "--batch", "2", "--steps", "2"]


def test_train_latent_parses_and_ignores_precision_remat_and_val_every(tmp_path, capsys):
    """``--precision bfloat16 --remat --val-every 5``: the run equals one without them (parameters and AdamW
    state, bitwise), and one line on stderr names the three flags; without them nothing is printed there."""
    t_cli.main(["train-latent", *TINY, "--out", str(tmp_path / "a")])
    assert "not acted on" not in capsys.readouterr().err
    t_cli.main(["train-latent", *TINY, "--precision", "bfloat16", "--remat", "--val-every", "5",
                "--out", str(tmp_path / "b")])
    err = [line for line in capsys.readouterr().err.splitlines() if "not acted on" in line]
    assert len(err) == 1 and all(f in err[0] for f in ("--precision bfloat16", "--remat", "--val-every 5"))
    want, got = _ckpt(tmp_path / "a" / "ckpt" / "step_2.pt"), _ckpt(tmp_path / "b" / "ckpt" / "step_2.pt")
    _assert_trees_equal(got, want)
