"""Shared CLI wiring, the eval half (counterpart of gator_tpu/cli/common.py):
config -> assets, datasets, model spec, batch pipeline, target regressor,
model and eval step, on one device.

`build_datasets` builds the datasets of a config by the reference's names
(`data.DATASETS`), from the first existing data directory
(`resolve_data_dirs`: $GATOR_DATA_DIR, ./data, the config's
BASE_DATA_DIR); `synthetic=True` swaps each for its in-memory stand-in, as
the JAX package does. The training half of `Session` (optimizers, train
steps) is not ported yet.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional

import torch

from ..assets import build_assets
from ..config import Config
from ..data import (DATASETS, BatchPipeline, GtSynthesizer, ProcessOptions,
                    SyntheticDataset)
from ..data.synthetic import synthetic_coco_dataset, synthetic_muco_dataset
from ..models import GatorSpec, GatSpec, build_gat, build_gator
from ..train import make_gat_eval_step, make_gator_eval_step

# h36m-target eval joints of a COCO-input GATOR (gator_tpu/cli/common.py:
# 316-319): the h36m eval subset
H36M_TARGET_EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)


def resolve_data_dirs(cfg: Config) -> List[str]:
    dirs = []
    env = os.environ.get("GATOR_DATA_DIR")
    if env:
        dirs.append(env)
    dirs.append(osp.join(os.getcwd(), "data"))
    base = cfg.DATASET.BASE_DATA_DIR
    if base and osp.isdir(base):
        dirs.append(osp.dirname(base.rstrip("/")) or ".")
    return dirs


def make_opts(cfg: Config, is_train: bool) -> ProcessOptions:
    return ProcessOptions(
        input_shape=tuple(cfg.MODEL.input_shape),
        use_gt_input=cfg.DATASET.use_gt_input,
        flip_enabled=cfg.AUG.flip, rotate_factor=cfg.AUG.rotate_factor,
        is_train=is_train, input_joint_name=cfg.DATASET.input_joint_set)


def build_datasets(cfg: Config, assets, names, is_train: bool,
                   debug: bool = False, synthetic_n: int = 256,
                   synthetic: bool = False,
                   synthesizer: Optional[GtSynthesizer] = None):
    """The datasets `names` by the reference's names. 'Synthetic' needs no
    external data. synthetic=True swaps every name for its in-memory
    stand-in: in training, COCO and MuCo get their schema-faithful
    fabricated tables, everything else is the SmplTable SyntheticDataset,
    so any recipe (the mixed detector-input flagship too) runs without
    downloads. `synthesizer` synthesises the stand-ins' tables (a new one
    on the card by default); the readers need none until `make_batch`."""
    opts = make_opts(cfg, is_train)
    stand_ins = {"COCO": synthetic_coco_dataset,
                 "MuCo": synthetic_muco_dataset} if is_train else {}
    data_dir = None
    out = []
    for name in names:
        if synthetic or name == "Synthetic":
            maker = stand_ins.get(name, SyntheticDataset)
            out.append(maker(assets, opts, n=synthetic_n, seed=cfg.seed,
                             synthesizer=synthesizer))
            continue
        if name not in DATASETS:
            raise ValueError(f"unknown dataset {name!r}; known: "
                             f"{sorted(DATASETS)}")
        if data_dir is None:
            dirs = resolve_data_dirs(cfg)
            data_dir = next((d for d in dirs if osp.isdir(d)), None)
            if data_dir is None:
                raise FileNotFoundError(
                    f"dataset {name!r}: none of the data directories "
                    f"{dirs} exists (set GATOR_DATA_DIR, or pass "
                    "--synthetic)")
        cls = DATASETS[name]
        if name == "Human36M":
            out.append(cls(assets, opts, data_dir,
                           "train" if is_train else "test", debug=debug))
        elif name == "PW3D":
            out.append(cls(assets, opts, data_dir, "test"))
        else:
            out.append(cls(assets, opts, data_dir, "train"))
    return out


class Session:
    """What one eval run needs, built once from a Config, on one device
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: Config, synthetic: bool = False, assets=None,
                 synthetic_n: int = 256, device="cuda", debug: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.assets = assets if assets is not None else build_assets(
            cfg.DATASET.input_joint_set, data_dirs=resolve_data_dirs(cfg))
        self.synth = GtSynthesizer(self.assets, self.device)
        self.datasets = build_datasets(
            cfg, self.assets, cfg.DATASET.test_list, is_train=False,
            debug=debug, synthetic_n=synthetic_n, synthetic=synthetic,
            synthesizer=self.synth)
        self.is_gator = cfg.MODEL.name == "GATOR"
        if self.is_gator:
            self.spec = GatorSpec.from_assets(
                self.assets, embed_dim=cfg.MODEL.embed_dim,
                depth=cfg.MODEL.depth, alpha=cfg.MODEL.alpha)
        else:
            self.spec = GatSpec.from_assets(
                self.assets, embed_dim=cfg.MODEL.embed_dim,
                depth=cfg.MODEL.depth)
        self.pipeline = BatchPipeline(
            self.datasets, self.synth, cfg.TEST.batch_size,
            shuffle=cfg.TEST.shuffle, seed=cfg.seed,
            stage="gator" if self.is_gator else "gat")
        self.target_regressor = (
            self.assets.j_regressor_h36m
            if cfg.DATASET.target_joint_set == "human36"
            else self.assets.j_regressor_coco)

    def build_model(self) -> torch.nn.Module:
        """The config's model (GATOR or the GAT lifter alone) on the
        session's device, with random weights from cfg.seed."""
        build = build_gator if self.is_gator else build_gat
        return build(self.spec, seed=self.cfg.seed, device=self.device)

    def make_eval_step(self, use_kernels: bool = True):
        """The eval step of the config's model; it always runs in f32
        (TF32 off). use_kernels=False keeps the MDR self-attention off K3."""
        jset = self.assets.joint_set
        if self.is_gator:
            return make_gator_eval_step(
                self.target_regressor,
                jset.eval_joints if jset.name == "human36"
                else H36M_TARGET_EVAL_JOINTS, use_kernels=use_kernels)
        return make_gat_eval_step(jset.eval_joints)
