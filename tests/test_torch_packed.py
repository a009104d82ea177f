"""The port's packed device pipeline (data/packed.py; TRAIN.gt_in_step
"packed" and "device"), the mixed pipeline's index-only batches and the
session's mode resolution, against the JAX package's, on the CPU.

The readers read the fabricated annotation trees of tests/torch_fixtures.py
(and tests/test_readers.py's AMASS files) in both packages. Packed-table
columns: from file tables bit-equal; from the SMPL pass within f32
rounding (joints 2e-3 mm, offsets 2e-6 m, effective poses and betas 1e-5,
pixels 1e-3); masks and genders equal. The batches the wrappers assemble
with the noise off (GT input) match the JAX package's at
tests/test_packed.py's bars: pose2d 1e-5, mesh 2e-6 m, joints 2e-3 mm,
masks equal. Where a reader regresses its joints in camera space metres
away (AMASS's virtual camera, MuCo's translation), the mm and metre bars
are at least 1e-6 of that distance: f32 rounding there, before the root
is subtracted. With detector input the "device" mode's 2D input is
standardised, keyed by (seed, step) and moved by the noise.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu import data as jdata
from gator_tpu.cli import common as jcommon
from gator_tpu.config import load_config as jload_config
from gator_tpu.data import packed as jpacked
from gator_tpu_torch import data as pdata
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli.common import Session
from gator_tpu_torch.config import load_config
from gator_tpu_torch.data import packed as ppacked
from gator_tpu_torch.data.device_pipeline import (_flip_perm,
                                                  crop_normalize_gt)
from test_torch_readers import both, one_torch_thread, trees  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOLS = {"pose2d": 1e-5, "mesh": 2e-6, "lift_pose3d": 2e-3,
        "reg_pose3d": 2e-3, "joint_cam": 2e-3}
COL_TOLS = {"pose_eff": 1e-5, "shape_eff": 1e-5, "trans_off": 2e-6,
            "root_mm": 2e-3, "joint_cam_input": 2e-3, "reg_pose": 2e-3,
            "joint_img_input": 1e-3}
# (reader, joint set, use_gt_input); the readers' train splits
CASES = {"h36m": ("Human36M", "human36", False),
         "h36m_coco": ("Human36M", "coco", False),
         "coco": ("COCO", "coco", False),
         "muco": ("MuCo", "coco", False),
         "muco_h36m": ("MuCo", "human36", True),
         "amass": ("AMASS", "human36", True)}


def _make(case, trees, both, use_gt=None):
    """-> (JAX reader, port reader, JAX synthesizer, port synthesizer)."""
    name, js, gt = CASES[case]
    ja, pa, jsyn, psyn = both[js]
    kw = dict(input_joint_name=js, use_gt_input=gt if use_gt is None
              else use_gt, flip_enabled=True, rotate_factor=30.0)
    return (jdata.DATASETS[name](ja, jdata.ProcessOptions(**kw),
                                 trees["chip"], "train"),
            pdata.DATASETS[name](pa, pdata.ProcessOptions(**kw),
                                 trees["chip"], "train"), jsyn, psyn)


def _spy(seen):
    def step(state, inner, *extra):
        seen.clear()
        seen.update(inner)
        return inner
    return step


def _bars(root_mm):
    """TOLS with the mm and metre bars raised to 1e-6 of the farthest
    root's camera distance."""
    d_mm = float(np.abs(np.asarray(root_mm)).max())
    return {k: max(v, 1e-6 * (d_mm / 1000.0 if k == "mesh" else d_mm))
            if k != "pose2d" else v for k, v in TOLS.items()}


def _check(got, want, tols=TOLS):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        if k.endswith("valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tols[k],
                                       err_msg=k)


class _State:
    def __init__(self, step):
        self.step = step


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_table_columns(case, trees, both):
    jd, pd, jsyn, psyn = _make(case, trees, both)
    want = jpacked.build_packed_tables([jd], jsyn, chunk=16)
    got = ppacked.build_packed_tables([pd], psyn, chunk=16)
    from_file = case == "h36m"
    bars = _bars(want.root_mm)
    col_tols = dict(COL_TOLS, trans_off=bars["mesh"],
                    **{k: bars["reg_pose3d"]
                       for k in ("root_mm", "joint_cam_input", "reg_pose")})
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None:
            assert g is None, f.name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, f.name
        if f.name in COL_TOLS and not (from_file and f.name in (
                "joint_img_input", "reg_pose", "root_mm")):
            np.testing.assert_allclose(g, w, rtol=0, atol=col_tols[f.name],
                                       err_msg=f.name)
        elif f.name == "crop_area":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert got.genders_present == want.genders_present
    assert pd._packed.row_offset == jd._packed.row_offset == 0


@pytest.mark.parametrize("case", ["h36m", "coco", "amass"])
def test_packed_and_device_batches_equal(case, trees, both):
    """make_packed_batch (the h36m noise draws from file rows bit-equal)
    and make_device_batch from one rng."""
    jd, pd, jsyn, psyn = _make(case, trees, both,
                               use_gt=None if case == "h36m" else True)
    jpacked.build_packed_tables([jd], jsyn, chunk=16)
    ppacked.build_packed_tables([pd], psyn, chunk=16)
    idx = np.arange(min(len(pd), 10))[::-1].copy()
    for form in ("make_packed_batch", "make_device_batch"):
        want = getattr(jpacked, form)(jd, idx, np.random.default_rng(2))
        got = getattr(ppacked, form)(pd, idx, np.random.default_rng(2))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            if k == "pose2d" and case != "h36m":
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.asarray(pd.make_packed_batch(idx, np.random.default_rng(2))
                      ["pose2d"]).shape == (len(idx), pd.joint_set.joint_num,
                                            2)


@pytest.mark.parametrize("device_input", [False, True])
@pytest.mark.parametrize("stage", ["gator", "gat"])
def test_wrappers_assemble_jax_targets(stage, device_input, trees, both):
    """The Human36M + COCO + MuCo mix (COCO joints, GT input: no noise):
    every dataset's rows through both packages' packed wrappers."""
    names = ("h36m_coco", "coco", "muco")
    made = [_make(c, trees, both, use_gt=True) for c in names]
    jds, pds = [m[0] for m in made], [m[1] for m in made]
    jsyn, psyn = made[0][2], made[0][3]
    jt = jpacked.build_packed_tables(jds, jsyn, chunk=16)
    pt = ppacked.build_packed_tables(pds, psyn, chunk=16)
    want, got = {}, {}
    jstep = jpacked.with_packed_input_pipeline(
        _spy(want), jt, jsyn, jds[0].joint_set, stage=stage,
        opts=jds[0].opts, device_input=device_input)
    pstep = ppacked.with_packed_input_pipeline(
        _spy(got), pt, psyn, pds[0].joint_set, stage=stage,
        opts=pds[0].opts, device_input=device_input)
    extra = (0, 1.0) if stage == "gator" else (0,)
    for jd, pd in zip(jds, pds):
        idx = np.arange(len(pd))
        batch = pd.make_packed_batch(idx, np.random.default_rng(3))
        if device_input:
            del batch["pose2d"]
        jstep(_State(jnp.asarray(0)), {k: jnp.asarray(v)
                                       for k, v in batch.items()},
              jax.random.PRNGKey(0), *(jnp.asarray(1.0),) * (len(extra) - 1))
        pstep(_State(0), batch, *extra)
        tols = _bars(jt.root_mm)
        _check(got, want, tols)
        # and the host path's batch at the same rows and draws
        host = pd.make_batch(idx, psyn, np.random.default_rng(3),
                             stage=stage)
        _check(got, {k: torch.as_tensor(v).numpy() for k, v in host.items()},
               tols)


def test_mixed_pipeline_device_mode(trees, both):
    """BatchPipeline(mode="device") over the Human36M + COCO + MuCo mix:
    the JAX pipeline's index batches (on the synthesizer's device), and
    the wrapper's targets from them."""
    names = ("h36m_coco", "coco", "muco")
    made = [_make(c, trees, both, use_gt=True) for c in names]
    jds, pds = [m[0] for m in made], [m[1] for m in made]
    jsyn, psyn = made[0][2], made[0][3]
    jt = jpacked.build_packed_tables(jds, jsyn, chunk=16)
    pt = ppacked.build_packed_tables(pds, psyn, chunk=16)
    jp = jdata.BatchPipeline(jds, jsyn, 8, seed=5, prefetch=0,
                             mode="device")
    pp = pdata.BatchPipeline(pds, psyn, 8, seed=5, drop_last=True,
                             mode="device")
    assert len(pp) == len(jp)
    want, got = {}, {}
    jstep = jpacked.with_packed_input_pipeline(
        _spy(want), jt, jsyn, jds[0].joint_set, opts=jds[0].opts,
        device_input=True)
    pstep = ppacked.with_packed_input_pipeline(
        _spy(got), pt, psyn, pds[0].joint_set, opts=pds[0].opts,
        device_input=True)
    jit, pit = iter(jp), iter(pp)
    for _ in range(3):
        jb, pb = next(jit), next(pit)
        assert set(pb) == {"row", "flips", "rots"}
        for k in jb:
            assert isinstance(pb[k], torch.Tensor)
            np.testing.assert_array_equal(pb[k].numpy(), jb[k], err_msg=k)
        jstep(_State(jnp.asarray(0)), {k: jnp.asarray(v)
                                       for k, v in jb.items()},
              jax.random.PRNGKey(0), jnp.asarray(1.0))
        pstep(_State(0), pb, 0, 1.0)
        _check(got, want, _bars(jt.root_mm))
    pit.close()


def test_device_mode_detector_noise(trees, both):
    """Detector input on the COCO reader: the in-step input is
    standardised, moved by the noise from the noise-free form, the same for
    one (seed, step) and another for the next step or seed."""
    jd, pd, _, psyn = _make("coco", trees, both)
    table = ppacked.build_packed_tables([pd], psyn, chunk=16)
    step = ppacked.with_packed_input_pipeline(
        _spy({}), table, psyn, pd.joint_set, opts=pd.opts,
        device_input=True)
    batch = ppacked.make_device_batch(pd, np.arange(len(pd)),
                                      np.random.default_rng(1))

    def pose2d(seed, at):
        return step.assemble(_State(at), batch, seed, 1.0)["pose2d"].numpy()

    p = pose2d(0, 0)
    assert p.shape == (len(pd), 19, 2) and np.isfinite(p).all()
    np.testing.assert_allclose(p.mean(1), 0.0, atol=1e-5)
    np.testing.assert_allclose(p.std(1), 1.0, atol=1e-4)
    perm = _flip_perm(pd.joint_set.joint_num, pd.joint_set.flip_pairs)
    clean = crop_normalize_gt(
        torch.as_tensor(pd._packed.joint_img_input), perm,
        pd.opts.input_shape, torch.as_tensor(batch["flips"]),
        torch.as_tensor(batch["rots"])).numpy()
    assert (np.linalg.norm(p - clean, axis=-1) > 0.05).mean() > 0.5
    np.testing.assert_array_equal(p, pose2d(0, 0))
    assert np.abs(pose2d(0, 1) - p).max() > 1e-3
    assert np.abs(pose2d(1, 0) - p).max() > 1e-3


def _stub_mode(jcfg, classes, is_gator, is_train=True):
    """The JAX session's mode resolution over bare reader instances of
    `classes` (its checks read class attributes only)."""
    stub = object.__new__(jcommon.Session)
    stub.datasets = [object.__new__(c) for c in classes]
    stub.is_gator = is_gator
    return jcommon.Session._resolve_gt_in_step(stub, jcfg, is_train)


@pytest.fixture(scope="module")
def port_assets():
    return {js: build_assets(js, data_dirs=[], synthetic_vertex_num=890,
                             seed=0) for js in ("human36", "coco")}


def _configs_with_gt_in_step():
    out = []
    for name in sorted(os.listdir(os.path.join(ROOT, "configs"))):
        with open(os.path.join(ROOT, "configs", name)) as f:
            if "gt_in_step" in f.read():
                out.append(name)
    return out


@pytest.mark.parametrize("name", _configs_with_gt_in_step())
def test_session_resolves_every_config_as_jax(name, port_assets):
    path = os.path.join(ROOT, "configs", name)
    cfg, jcfg = load_config(path), jload_config(path)
    stand_in = {"COCO": jdata.CocoDataset, "MuCo": jdata.MucoDataset}
    classes = [stand_in.get(n, jdata.SyntheticDataset)
               for n in jcfg.DATASET.train_list]
    want = _stub_mode(jcfg, classes, jcfg.MODEL.name == "GATOR")
    sess = Session(cfg, synthetic=True, synthetic_n=16, device="cpu",
                   assets=port_assets[cfg.DATASET.input_joint_set],
                   is_train=True)
    assert sess.gt_in_step == want
    mode = {"off": "full", "on": "raw", "full": "index",
            "packed": "packed", "device": "device"}[want]
    assert sess.pipeline.mode == mode and sess.pipeline.drop_last


def _cfg(train_list, use_gt, joints, gt_in_step, name="GATOR"):
    over = {"DATASET": {"train_list": list(train_list),
                        "test_list": ["PW3D"], "input_joint_set": joints,
                        "target_joint_set": "human36",
                        "use_gt_input": use_gt},
            "MODEL": {"name": name, "embed_dim": 64, "depth": 1},
            "TRAIN": {"batch_size": 8, "gt_in_step": gt_in_step}}
    return load_config(None, over), jload_config(None, over)


def test_session_mode_resolution(port_assets):
    """tests/test_packed.py:426-477's cases: auto -> full / device, an
    explicit packed, the full error on the detector mix, eval -> off."""
    mix = ("Human36M", "COCO", "MuCo")

    def sess(cfg, **kw):
        return Session(cfg, synthetic=True, synthetic_n=16, device="cpu",
                       assets=port_assets[cfg.DATASET.input_joint_set],
                       **kw)

    cfg, _ = _cfg(["Human36M"], True, "human36", "auto")
    assert sess(cfg, is_train=True).gt_in_step == "full"
    cfg, _ = _cfg(mix, False, "coco", "auto")
    s = sess(cfg, is_train=True)
    assert s.gt_in_step == "device" and len(s.datasets) == 3
    assert s._packed_table is not None
    cfg, _ = _cfg(mix, False, "coco", "packed")
    assert sess(cfg, is_train=True).gt_in_step == "packed"
    cfg, jcfg = _cfg(mix, False, "coco", "full")
    with pytest.raises(ValueError, match="packed") as err:
        sess(cfg, is_train=True)
    classes = [jdata.SyntheticDataset, jdata.CocoDataset, jdata.MucoDataset]
    with pytest.raises(ValueError) as jerr:
        _stub_mode(jcfg, classes, True)
    assert str(err.value) == str(jerr.value)
    cfg, _ = _cfg(["Human36M"], True, "human36", "auto")
    s = sess(cfg)
    assert s.gt_in_step == "off" and s.pipeline.mode == "full"
    assert not s.pipeline.drop_last
