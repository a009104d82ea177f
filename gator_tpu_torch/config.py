"""Frozen-dataclass configuration of the reference YAML schema (counterpart
of gator_tpu/config.py, restated here because the port imports nothing of
the JAX package).

Every key of every `configs/*.yml` loads, with the same defaults and the
same strict checking: an unknown section or key raises ValueError
(reference: lib/core/config.py:94-116). `TRAIN.gt_in_step` and
`gt_mesh_cache` pick a training session's input path
(`cli.common.Session`), `fused_kernels` is checked there ("auto" and "on"
train on the kernels K4 and K5, "off" raises: the port has no module-form
dropout path). `TRAIN.steps_per_dispatch` (the JAX package's multi-step
dispatch) loads here and the port does not act on it: the train CLI runs
one step per dispatch and says so once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import yaml


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    train_list: Tuple[str, ...] = ("Human36M", "COCO", "MuCo")
    test_list: Tuple[str, ...] = ("PW3D",)
    input_joint_set: str = "coco"
    target_joint_set: str = "human36"
    workers: int = 16
    use_gt_input: bool = True
    BASE_DATA_DIR: str = "data/base_data"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "GATOR"
    input_shape: Tuple[int, int] = (384, 288)   # (H, W)
    normal_loss_weight: float = 1e-1
    edge_loss_weight: float = 20.0
    joint_loss_weight: float = 1e-3
    posenet_pretrained: bool = False
    posenet_path: str = ""
    alpha: bool = False
    embed_dim: int = 128
    depth: int = 6
    num_heads: int = 8
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    print_freq: int = 10
    batch_size: int = 64
    shuffle: bool = True
    begin_epoch: int = 1
    end_epoch: int = 40
    edge_loss_start: int = 15
    scheduler: str = "step"
    lr: float = 1e-3
    lr_step: Tuple[int, ...] = (30,)
    lr_factor: float = 0.1
    optimizer: str = "adam"
    wandb: bool = False
    precision: str = "float32"
    fused_kernels: str = "auto"
    steps_per_dispatch: int = 1
    gt_in_step: str = "off"
    gt_mesh_cache: str = "auto"


@dataclasses.dataclass(frozen=True)
class AugConfig:
    flip: bool = False
    rotate_factor: float = 0.0


@dataclasses.dataclass(frozen=True)
class TestConfig:
    batch_size: int = 64
    shuffle: bool = False
    weight_path: str = ""
    vis: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    DATASET: DatasetConfig = DatasetConfig()
    MODEL: ModelConfig = ModelConfig()
    TRAIN: TrainConfig = TrainConfig()
    AUG: AugConfig = AugConfig()
    TEST: TestConfig = TestConfig()
    seed: int = 0
    output_dir: str = "experiment"


_SECTIONS = ("DATASET", "MODEL", "TRAIN", "AUG", "TEST")


def _replace_section(section, overrides: dict):
    valid = {f.name for f in dataclasses.fields(section)}
    clean = {}
    for key, val in overrides.items():
        if key not in valid:
            raise ValueError(
                f"{type(section).__name__}.{key} not a valid config key")
        clean[key] = tuple(val) if isinstance(val, list) else val
    return dataclasses.replace(section, **clean)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Load a reference-schema YAML into an immutable Config; `overrides`
    ({section: {key: value}} or {key: value}) apply on top of the file."""
    cfg = Config()
    raw = {}
    if yaml_path:
        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
    for key, val in (overrides or {}).items():
        raw.setdefault(key, {})
        if isinstance(val, dict) and isinstance(raw[key], dict):
            raw[key] = {**raw[key], **val}
        else:
            raw[key] = val
    updates = {}
    for key, val in raw.items():
        if key in _SECTIONS:
            if val is None:          # e.g. 'AUG:' with every key commented
                continue
            if not isinstance(val, dict):
                raise ValueError(
                    f"config section {key} must be a mapping, got "
                    f"{type(val).__name__}")
            updates[key] = _replace_section(getattr(cfg, key), val)
        elif hasattr(cfg, key):
            updates[key] = val
        else:
            raise ValueError(f"{key} not a valid config section/key")
    return dataclasses.replace(cfg, **updates)
