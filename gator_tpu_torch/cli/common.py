"""Shared CLI wiring (counterpart of gator_tpu/cli/common.py): config ->
assets, datasets, model spec, batch pipeline, target regressor, model,
eval step and, in a training session, the input mode and the train step,
on one device or on this process's card of a data-parallel world.

`build_datasets` builds the datasets of a config by the reference's names
(`data.DATASETS`), from the first existing data directory
(`resolve_data_dirs`: $GATOR_DATA_DIR, ./data, the config's
BASE_DATA_DIR); `synthetic=True` swaps each for its in-memory stand-in, as
the JAX package does.

A training session (`is_train=True`) resolves TRAIN.gt_in_step as the JAX
session does (`_resolve_gt_in_step`): "auto" picks "full" for a GT-input,
non-COCO, single shared-path dataset, else "device" when every dataset has
a `packed_rows` hook, else "off"; an explicit mode the recipe cannot run
raises. The pipeline then makes that mode's batches, and
`make_train_step` wraps the stage's step on K4/K5 so that it assembles
its inputs and targets on the device. `make_optimizer` picks the optimizer
and the LR schedule from TRAIN.optimizer and TRAIN.scheduler, as the JAX
session does. TRAIN.fused_kernels: "auto" (the kernels on the card, their
plain versions on the CPU) and "on" (the card only) both train on K4/K5;
"off" is the JAX package's module form with flax dropout, which the port
does not have (its modules carry no dropout), so it raises, as does an
unknown value. The train CLI is `cli/train.py`.

Data parallelism (`world=`, a `parallel.World`): the session's device is
the rank's (`world.device`); a training session's pipeline makes each
rank's rows of the global batch of TRAIN.batch_size, and its train step
takes them (`train.loop`); the model is built from cfg.seed on every rank
and broadcast from rank 0 once. An eval session's pipeline makes whole
batches, which `run_eval(world=)` shards.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Callable, List, Optional

import torch

from ..assets import build_assets
from ..config import Config
from ..data import (DATASETS, BatchPipeline, GtSynthesizer, ProcessOptions,
                    SyntheticDataset)
from ..data.synthetic import synthetic_coco_dataset, synthetic_muco_dataset
from .. import losses
from ..models import GatorSpec, GatSpec, build_gat, build_gator
from ..parallel import broadcast_module
from ..train import (OptimizerFactory, ReduceLROnPlateau, TrainState,
                     make_gat_eval_step, make_gat_train_step,
                     make_gator_eval_step, make_gator_train_step,
                     multistep_lr)

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
    """What one training or eval run needs, built once from a Config, on
    one device (the card unless the caller asks for the CPU), or with a
    `world` on the rank's device (module docstring). An eval session (the
    default) reads TEST's datasets; a training session (`is_train=True`)
    reads TRAIN's and resolves the input mode."""

    def __init__(self, cfg: Config, synthetic: bool = False, assets=None,
                 synthetic_n: int = 256, device="cuda", debug: bool = False,
                 is_train: bool = False, world=None):
        self.cfg = cfg
        self.world = world
        self.device = world.device if world is not None \
            else torch.device(device)
        self.assets = assets if assets is not None else build_assets(
            cfg.DATASET.input_joint_set, data_dirs=resolve_data_dirs(cfg))
        self.synth = GtSynthesizer(self.assets, self.device)
        self.datasets = build_datasets(
            cfg, self.assets,
            cfg.DATASET.train_list if is_train else cfg.DATASET.test_list,
            is_train=is_train, debug=debug, synthetic_n=synthetic_n,
            synthetic=synthetic, synthesizer=self.synth)
        self.is_gator = cfg.MODEL.name == "GATOR"
        if self.is_gator:
            self.spec = GatorSpec.from_assets(
                self.assets, embed_dim=cfg.MODEL.embed_dim,
                depth=cfg.MODEL.depth, alpha=cfg.MODEL.alpha)
        else:
            self.spec = GatSpec.from_assets(
                self.assets, embed_dim=cfg.MODEL.embed_dim,
                depth=cfg.MODEL.depth)
        self.gt_in_step = self._resolve_gt_in_step(cfg, is_train)
        mode = {"off": "full", "on": "raw", "full": "index",
                "packed": "packed", "device": "device"}[self.gt_in_step]
        self.pipeline = BatchPipeline(
            self.datasets, self.synth,
            cfg.TRAIN.batch_size if is_train else cfg.TEST.batch_size,
            shuffle=cfg.TRAIN.shuffle if is_train else cfg.TEST.shuffle,
            seed=cfg.seed, stage="gator" if self.is_gator else "gat",
            drop_last=is_train, mode=mode,
            world=world if is_train else None)
        self._packed_table = None
        self.plateau = None        # set by make_optimizer
        if self.gt_in_step in ("packed", "device"):
            # now: packed and device batches read each dataset's PackedView
            self.packed_table()
        self.target_regressor = (
            self.assets.j_regressor_h36m
            if cfg.DATASET.target_joint_set == "human36"
            else self.assets.j_regressor_coco)

    # -- the in-step input mode (gator_tpu/cli/common.py:150-223) ----------

    def _full_mode_ok(self, cfg) -> bool:
        """gt_in_step='full' (index-only batches, the whole input pipeline
        in the step) needs GT 2D input, a non-COCO joint set and one
        shared-path dataset (one table on the device)."""
        return (cfg.DATASET.use_gt_input
                and cfg.DATASET.input_joint_set != "coco"
                and len(self.datasets) == 1
                and all(getattr(d, "supports_raw_batches", False)
                        for d in self.datasets))

    def _packed_mode_ok(self) -> bool:
        """gt_in_step='packed' or 'device' needs every dataset's
        packed_rows precompute."""
        return all(hasattr(d, "packed_rows") for d in self.datasets)

    def _resolve_gt_in_step(self, cfg, is_train: bool) -> str:
        """cfg.TRAIN.gt_in_step -> the mode this session runs. "auto"
        picks "full" for GT-input single-dataset non-COCO sessions, else
        "device" when every dataset supports the packed precompute (the
        flagship detector-input H36M+COCO+MuCo mix), else "off". Explicit
        values are checked and raise when the recipe cannot run them. An
        eval session runs "off"."""
        req = cfg.TRAIN.gt_in_step
        if req not in ("off", "on", "full", "packed", "device", "auto"):
            raise ValueError(
                f"TRAIN.gt_in_step must be 'off', 'on', 'full', 'packed',"
                f" 'device', or 'auto'; got {req!r}")
        if not is_train or req == "off":
            return "off"
        if req == "auto":
            if self._full_mode_ok(cfg):
                return "full"
            if self._packed_mode_ok():
                return "device"
            return "off"
        if req in ("packed", "device"):
            if not self._packed_mode_ok():
                bad = [type(d).__name__ for d in self.datasets
                       if not hasattr(d, "packed_rows")]
                raise ValueError(
                    f"TRAIN.gt_in_step={req}: no packed_rows precompute "
                    f"for {bad}")
            return req
        # "on" (in-step GT synthesis) means something for the gator stage
        # only: gat batches carry no mesh, so it degrades to "off"
        if req == "on" and not self.is_gator:
            return "off"
        bad = [type(d).__name__ for d in self.datasets
               if not getattr(d, "supports_raw_batches", False)]
        if cfg.DATASET.input_joint_set == "coco" or bad:
            raise ValueError(
                "TRAIN.gt_in_step on/full needs non-COCO input and "
                f"shared-path datasets (unsupported: {bad}); use "
                "gt_in_step=packed (or auto) for detector/COCO-input "
                "recipes")
        if req == "full" and (len(self.datasets) != 1
                              or not cfg.DATASET.use_gt_input):
            raise ValueError("TRAIN.gt_in_step=full needs GT input and a "
                             "single dataset (one device-resident table)")
        return req

    def packed_table(self):
        """The session's packed table (built once), for gt_in_step
        'packed' and 'device'."""
        if self._packed_table is None:
            from ..data.packed import build_packed_tables
            self._packed_table = build_packed_tables(self.datasets,
                                                     self.synth)
        return self._packed_table

    def _mesh_cache_on(self, n_rows: int) -> bool:
        """cfg.TRAIN.gt_mesh_cache for a table of n_rows: 'auto' turns the
        once-a-run GT-mesh precompute on when [N, V, 3] f32 fits 2 GiB."""
        req = self.cfg.TRAIN.gt_mesh_cache
        if req not in ("auto", "on", "off"):
            raise ValueError(
                f"TRAIN.gt_mesh_cache must be 'auto', 'on', or 'off'; "
                f"got {req!r}")
        if req != "auto":
            return req == "on"
        v = self.spec.mdr.full_num if self.is_gator else 0
        return bool(v) and n_rows * v * 3 * 4 <= 2 << 30

    # -- model, optimizer and steps ----------------------------------------

    def make_optimizer(self) -> OptimizerFactory:
        """cfg.TRAIN.optimizer at cfg.TRAIN.lr, with cfg.TRAIN.scheduler
        (gator_tpu/cli/common.py:233-252): 'step' -> MultiStepLR over
        len(self.pipeline) steps an epoch, applied on every update;
        'platue' [sic, the reference's spelling] or 'plateau' -> a constant
        lr that the host-side ReduceLROnPlateau, `self.plateau`, resets once
        an epoch (reference: lib/funcs_utils.py:100-107)."""
        cfg = self.cfg
        self.plateau = None
        if cfg.TRAIN.scheduler in ("platue", "plateau"):
            self.plateau = ReduceLROnPlateau(cfg.TRAIN.lr,
                                             cfg.TRAIN.lr_factor)
            return OptimizerFactory(cfg.TRAIN.optimizer, cfg.TRAIN.lr)
        if cfg.TRAIN.scheduler != "step":
            raise ValueError(
                f"unknown cfg.TRAIN.scheduler {cfg.TRAIN.scheduler!r} "
                "(expected 'step' or 'platue')")
        steps_per_epoch = max(1, len(self.pipeline))
        return OptimizerFactory(
            cfg.TRAIN.optimizer, cfg.TRAIN.lr,
            multistep_lr(cfg.TRAIN.lr, cfg.TRAIN.lr_step,
                         cfg.TRAIN.lr_factor, steps_per_epoch))

    def _check_fused_kernels(self) -> None:
        """cfg.TRAIN.fused_kernels: 'auto' and 'on' train on K4/K5 ('on'
        only where the session is on the card); 'off' and anything else
        raise."""
        req = self.cfg.TRAIN.fused_kernels
        if req == "auto":
            return
        if req == "on":
            if self.device.type != "cuda":
                raise ValueError(
                    "TRAIN.fused_kernels=on needs the card (a CUDA "
                    f"device); this session is on {self.device}")
            return
        if req == "off":
            raise ValueError(
                "TRAIN.fused_kernels=off (the module form with flax "
                "dropout) is not ported: the port always trains on its "
                "kernels K4/K5; use 'auto' or 'on'")
        raise ValueError(f"TRAIN.fused_kernels must be 'auto', 'on' or "
                         f"'off'; got {req!r}")

    def build_model(self) -> torch.nn.Module:
        """The config's model (GATOR or the GAT lifter alone) on the
        session's device, with random weights from cfg.seed."""
        build = build_gator if self.is_gator else build_gat
        return build(self.spec, seed=self.cfg.seed, device=self.device)

    def make_train_step(self, optimizer: Callable):
        """-> (TrainState, step): the stage's train step on K4/K5 in
        cfg.TRAIN.precision, wrapped for the session's input mode
        (gator_tpu/cli/common.py:269-341 `make_steps`), and a state over
        `build_model()` with the optimizer `optimizer(parameters)`:
        `make_optimizer()`'s factory, whose step schedule the state then
        applies on every update, or any callable. cfg.TRAIN.fused_kernels
        is checked first (`_check_fused_kernels`). The stage-2 step is
        `step(state, batch, seed, edge_enabled)`, the stage-1 step
        `step(state, batch, seed)`; either takes the pipeline's batches,
        and a wrapped step carries its input assembly as `step.assemble`.
        With a world, the model is broadcast from rank 0.
        """
        from ..data.device_pipeline import (with_device_input_pipeline,
                                            with_device_input_pipeline_gat)
        from ..data.packed import with_packed_input_pipeline
        from ..train.loop import with_gt_synthesis

        self._check_fused_kernels()
        cfg = self.cfg
        dtype = (torch.bfloat16 if cfg.TRAIN.precision == "bfloat16"
                 else torch.float32)
        mode = self.gt_in_step
        ds = self.datasets[0]
        if self.is_gator:
            step = make_gator_train_step(
                self.spec, self.assets.faces, self.target_regressor,
                losses.LossWeights(normal=cfg.MODEL.normal_loss_weight,
                                   edge=cfg.MODEL.edge_loss_weight,
                                   joint=cfg.MODEL.joint_loss_weight),
                dtype=dtype, world=self.world)
            if mode == "on":
                step = with_gt_synthesis(step, self.synth,
                                         ds.opts.fitting_thr)
            elif mode == "full":
                step = with_device_input_pipeline(
                    step, self.synth, ds.table, ds.joint_set, ds.opts,
                    ds.opts.fitting_thr,
                    mesh_cache=self._mesh_cache_on(len(ds)))
            elif mode in ("packed", "device"):
                table = self.packed_table()
                step = with_packed_input_pipeline(
                    step, table, self.synth, self.assets.joint_set,
                    stage="gator", opts=ds.opts,
                    device_input=mode == "device",
                    mesh_cache=self._mesh_cache_on(len(table)),
                    world=self.world)
        else:
            step = make_gat_train_step(self.spec, dtype=dtype,
                                       world=self.world)
            if mode == "full":
                step = with_device_input_pipeline_gat(
                    step, ds.table, ds.joint_set, ds.opts, self.device)
            elif mode in ("packed", "device"):
                step = with_packed_input_pipeline(
                    step, self.packed_table(), self.synth,
                    self.assets.joint_set, stage="gat", opts=ds.opts,
                    device_input=mode == "device", world=self.world)
        model = broadcast_module(self.build_model(), self.world)
        return TrainState(model, optimizer(model.parameters()),
                          lr_schedule=getattr(optimizer, "schedule",
                                              None)), step

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
