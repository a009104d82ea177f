"""Shared CLI wiring, the eval half (counterpart of gator_tpu/cli/common.py):
config -> assets, datasets, model spec, batch pipeline, target regressor,
model and eval step, on one device.

The port reads synthetic data only: every dataset name of a config stands
for a `SyntheticDataset` under `synthetic=True`, as in the JAX package,
and the real-dataset readers (Human36M, 3DPW, ...) are not ported yet. The
training half of `Session` (optimizers, train steps) is not either.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List

import torch

from ..assets import build_assets
from ..config import Config
from ..data import (BatchPipeline, GtSynthesizer, ProcessOptions,
                    SyntheticDataset)
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


def build_eval_datasets(cfg: Config, assets, synthesizer: GtSynthesizer,
                        synthetic_n: int = 256, synthetic: bool = False):
    """The test datasets of `cfg` by the reference's names. With
    synthetic=True every name is an in-memory SyntheticDataset, as in the
    JAX package's eval; without it only 'Synthetic' is known yet."""
    opts = ProcessOptions(
        input_shape=tuple(cfg.MODEL.input_shape),
        use_gt_input=cfg.DATASET.use_gt_input,
        flip_enabled=cfg.AUG.flip, rotate_factor=cfg.AUG.rotate_factor,
        is_train=False, input_joint_name=cfg.DATASET.input_joint_set)
    out = []
    for name in cfg.DATASET.test_list:
        if not synthetic and name != "Synthetic":
            raise NotImplementedError(
                f"dataset {name!r}: the real-dataset readers are not ported "
                "yet; pass --synthetic")
        out.append(SyntheticDataset(assets, opts, n=synthetic_n,
                                    seed=cfg.seed, synthesizer=synthesizer))
    return out


class Session:
    """What one eval run needs, built once from a Config, on one device
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: Config, synthetic: bool = False, assets=None,
                 synthetic_n: int = 256, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.assets = assets if assets is not None else build_assets(
            cfg.DATASET.input_joint_set, data_dirs=resolve_data_dirs(cfg))
        self.synth = GtSynthesizer(self.assets, self.device)
        self.datasets = build_eval_datasets(cfg, self.assets, self.synth,
                                            synthetic_n=synthetic_n,
                                            synthetic=synthetic)
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
