"""Typed configuration (port of ``mrisr_tpu/config.py``).

One dataclass tree and a loader that takes YAML or JSON.  The YAML loader
adds the implicit float resolver the reference needs (so ``1e-2`` parses as
a float, not a string) on a SafeLoader subclass.  A YAML file needs the
``yaml`` package, as in the reference; JSON needs nothing.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def _yaml_loader():
    import yaml

    class FloatLoader(yaml.SafeLoader):
        pass

    FloatLoader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:
             [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return FloatLoader


@dataclass
class ScheduleConfig:
    kind: str = "linear"
    timesteps: int = 1000
    beta_start: float = 1e-6
    beta_end: float = 1e-2
    zero_terminal_snr: bool = False
    timestep_spacing: str = "trailing"
    prediction_type: str = "epsilon"


@dataclass
class ModelConfig:
    name: str = "resdiff_unet"
    image_size: int = 256
    in_channels: int = 1
    inner_channel: int = 32
    channel_mults: tuple = (1, 2, 4, 4)
    res_blocks: int = 1
    attn_res: tuple = (8,)
    norm_groups: int = 16
    dropout: float = 0.2
    use_checkpoint: bool = True


@dataclass
class OptimConfig:
    kind: str = "adam"
    lr: float = 1e-5
    lr_scheduler: str = "constant"
    warmup_steps: int = 0
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float | None = None
    ema_decay: float = 0.0


@dataclass
class DataConfig:
    data_dir: str = ""
    dataset: str = "fastmri"
    resolution: int = 256
    batch_size: int = 8
    slice_axis: int = 2
    scale_factor: float = 4.0
    contrast: str = "T2"
    field_strength: str = "3.0T"
    modality: str = "T2w"
    lr_clip: tuple = (0, 2000)
    hr_clip: tuple = (0, 900)
    num_prefetch: int = 2


@dataclass
class TrainConfig:
    max_steps: int = 100_000
    log_every: int = 100
    val_every: int = 5000
    checkpoint_every: int = 2000
    seed: int = 42
    mixed_precision: str = "bfloat16"
    gradient_accumulation: int = 1
    proportion_empty_prompts: float = 0.1
    output_dir: str = "./outputs"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    extras: dict = field(default_factory=dict)


def _merge_dataclass(dc, d: dict):
    names = {f.name: f for f in dataclasses.fields(dc)}
    updates = {}
    extras = {}
    for k, v in d.items():
        if k not in names:
            extras[k] = v
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _merge_dataclass(cur, v)[0]
        elif isinstance(cur, tuple) and isinstance(v, list):
            updates[k] = tuple(v)
        else:
            updates[k] = v
    return dataclasses.replace(dc, **updates), extras


def load_config(path: str | Path | None = None, overrides: dict | None = None) -> Config:
    cfg = Config()
    raw: dict = {}
    if path is not None:
        text = Path(path).read_text()
        if str(path).endswith(".json"):
            raw = json.loads(text)
        else:
            import yaml

            raw = yaml.load(text, Loader=_yaml_loader()) or {}
    if overrides:
        raw = _deep_merge(raw, overrides)
    cfg, extras = _merge_dataclass(cfg, raw)
    if extras:
        cfg = dataclasses.replace(cfg, extras={**cfg.extras, **extras})
    return cfg


def _deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def config_to_flat_dict(cfg: Config, prefix: str = "") -> dict[str, Any]:
    """Flatten for experiment-tracker logging (utils.py log_configs analog)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(config_to_flat_dict(v, key + "."))
        else:
            out[key] = v
    return out
