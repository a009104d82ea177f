"""The port's dataset readers (Human36M, PW3D, COCO, MuCo, AMASS), their
batches, their metric suites, the COCO/MuCo stand-ins and
`cli.common.build_datasets`, against the JAX package's on the same
fabricated annotation files (real schemas) and small assets (890
vertices).

Bars: tables read from files, and 2D inputs built from them (GT input,
test-time detections, the h36m and COCO detector-noise simulators), are
bit-equal from one seed; GT meshes within 1e-4 m in f32, joints within
0.1 mm, inputs derived from the device's SMPL pass within 1e-4; the
metric suites within rtol 1e-5 on the same predictions; the stand-ins'
tables within rtol 1e-4 (their keypoints come from the SMPL pass). The
files are those of tests/torch_fixtures.py's writer at a small size (what
the card's tests read at full size) and of tests/test_readers.py (the
readers' filter cases and AMASS).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from gator_tpu import data as jdata
from gator_tpu.cli import common as jcommon
from gator_tpu.config import load_config as jload_config
from gator_tpu_torch import data as pdata
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import common as pcommon
from gator_tpu_torch.config import load_config
from test_readers import (_write_amass_fixture, _write_coco_fixture,
                          _write_h36m_fixture, _write_muco_fixture,
                          _write_pw3d_fixture)
from torch_fixtures import write_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (here and in the port's test files
    that import this fixture): the suite runs several pytest workers on
    the same cores, and a multi-threaded CPU op then waits for threads
    that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"chip": tests/torch_fixtures.py's tree at a small size, plus
    AMASS; "jax": tests/test_readers.py's trees}."""
    chip = str(tmp_path_factory.mktemp("chip"))
    write_fixtures(chip, h36m_test=60, h36m_train=40, pw3d=12, coco=10,
                   muco=10, seed=3)
    _write_amass_fixture(chip)
    jax_tree = str(tmp_path_factory.mktemp("jaxtree"))
    for write in (_write_h36m_fixture, _write_pw3d_fixture,
                  _write_coco_fixture, _write_muco_fixture,
                  _write_amass_fixture):
        write(jax_tree)
    return {"chip": chip, "jax": jax_tree}


@pytest.fixture(scope="module")
def both(small_assets, small_assets_coco):
    """Per joint set: (JAX assets, port assets, JAX synthesizer, port
    synthesizer on the CPU)."""
    out = {}
    for js, ja in (("human36", small_assets), ("coco", small_assets_coco)):
        pa = build_assets(js, data_dirs=[], synthetic_vertex_num=890, seed=0)
        out[js] = (ja, pa, jdata.GtSynthesizer(ja),
                   pdata.GtSynthesizer(pa, "cpu"))
    return out


def _opts(js, **kw):
    o = dict(input_joint_name=js, **kw)
    return jdata.ProcessOptions(**o), pdata.ProcessOptions(**o)


# (tree, reader, split, joint set, use_gt_input, extra kwargs)
READERS = {
    "h36m_test_det": ("chip", "Human36M", "test", "human36", False, {}),
    "h36m_test_gt": ("chip", "Human36M", "test", "human36", True, {}),
    "h36m_train_noise": ("chip", "Human36M", "train", "human36", False, {}),
    "h36m_test_debug": ("chip", "Human36M", "test", "human36", True,
                        {"debug": True}),
    "h36m_test_jaxtree": ("jax", "Human36M", "test", "human36", True, {}),
    "pw3d_det": ("chip", "PW3D", "test", "coco", False, {}),
    "pw3d_gt": ("chip", "PW3D", "test", "coco", True, {}),
    "pw3d_jaxtree": ("jax", "PW3D", "test", "coco", False, {}),
    "coco": ("chip", "COCO", "train", "coco", True, {}),
    "coco_jaxtree": ("jax", "COCO", "train", "coco", True, {}),
    "muco": ("chip", "MuCo", "train", "coco", True, {}),
    "muco_h36m_input": ("jax", "MuCo", "train", "human36", True, {}),
    "amass": ("chip", "AMASS", "train", "human36", True, {}),
    "amass_gat": ("jax", "AMASS", "train", "coco", True,
                  {"model_name": "GAT"}),
}


def _readers(case, trees, both, **opt_kw):
    tree, name, split, js, use_gt, kw = READERS[case]
    ja, pa, jsyn, psyn = both[js]
    jo, po = _opts(js, use_gt_input=use_gt, **opt_kw)
    jd = jdata.DATASETS[name](ja, jo, trees[tree], split, **kw)
    pd = pdata.DATASETS[name](pa, po, trees[tree], split, **kw)
    return jd, pd, jsyn, psyn


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(READERS))
def test_tables_bit_equal(case, trees, both):
    jd, pd, _, _ = _readers(case, trees, both)
    assert type(pd).__name__ == type(jd).__name__ and len(pd) == len(jd) > 0
    for f in dataclasses.fields(jd.table):
        want = getattr(jd.table, f.name)
        got = getattr(pd.table, f.name)
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    if hasattr(jd, "detected_pose"):
        if jd.detected_pose is None:
            assert pd.detected_pose is None
        else:
            np.testing.assert_array_equal(pd.detected_pose, jd.detected_pose)
    if case == "h36m_test_det":
        # the detections file carries the rows the skip list drops
        assert len(pd) == 58 and pd.detected_pose.shape == (58, 17, 2)
    assert pd.opts == pdata.ProcessOptions(**jd.opts.__dict__)


# keys built from file tables alone: bit-equal; the rest derive from the
# SMPL pass
FILE_KEYS = {"h36m_test_det": ("pose2d", "lift_pose3d", "reg_pose3d"),
             "h36m_test_gt": ("pose2d", "lift_pose3d", "reg_pose3d"),
             "h36m_train_noise": ("pose2d", "lift_pose3d", "reg_pose3d"),
             "h36m_test_debug": ("pose2d",),
             "h36m_test_jaxtree": ("pose2d",),
             "pw3d_det": ("pose2d",), "pw3d_jaxtree": ("pose2d",)}
MM_KEYS = ("lift_pose3d", "reg_pose3d", "joint_cam")


@pytest.mark.parametrize("stage", ["gator", "gat"])
@pytest.mark.parametrize("case", sorted(READERS))
def test_batches_match(case, stage, trees, both):
    """make_batch from one seed, augmentation on (training readers): file
    keys bit-equal, meshes within 1e-4 m, joints within 0.1 mm, inputs
    from the SMPL pass within 1e-4, validity masks equal."""
    jd, pd, jsyn, psyn = _readers(case, trees, both, flip_enabled=True,
                                  rotate_factor=30.0)
    idx = np.arange(min(len(jd), 8))[::-1].copy()
    want = jd.make_batch(idx, jsyn, np.random.default_rng(1), stage=stage)
    got = pd.make_batch(idx, psyn, np.random.default_rng(1), stage=stage)
    assert set(got) == set(want)
    if "mesh" in want:
        assert isinstance(got["mesh"], torch.Tensor)
    for k in want:
        g, w = _host(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in FILE_KEYS.get(case, ()) or k.endswith("valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "mesh":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
        else:
            tol = 0.1 if k in MM_KEYS else 1e-4
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)


def test_coco_noise_batches_bit_equal(trees, both):
    """COCO detector-noise training inputs: the same COCO keypoints (the
    JAX synthesizer's, so that no f32 rounding of the SMPL pass moves a
    draw across an acceptance radius) through both packages'
    assemble_batch, from one seed, augmentation on."""
    from gator_tpu.data import base as jbase
    from gator_tpu_torch.data import base as pbase

    jd, _, jsyn, _ = _readers("h36m_train_noise", trees, both)
    t = jd.table
    idx = np.arange(24)
    out = jsyn.synthesize(t.pose[idx], t.shape[idx], t.trans[idx],
                          t.cam_r[idx], t.cam_t[idx], t.focal[idx],
                          t.princpt[idx], t.joint_cam_h36m[idx])
    img = np.asarray(out["joint_img_coco"])[:, :, :2]
    cam = np.asarray(out["joint_cam_coco"])
    reg = t.joint_cam_h36m[idx] - t.joint_cam_h36m[idx][:, :1]
    jo, po = _opts("coco", use_gt_input=False, flip_enabled=True,
                   rotate_factor=30.0)
    coco_set = both["coco"][0].joint_set
    res = []
    for mod, opts in ((jbase, jo), (pbase, po)):
        rng = np.random.default_rng(5)
        b = mod.assemble_batch(
            opts, coco_set, rng, "gator", mesh_rel_m=np.zeros((24, 0, 3)),
            joint_img_b=img, joint_cam_b=cam - cam[:, -2:-1], reg_pose=reg,
            fit_err=np.asarray(out["fitting_error"]),
            bad_zero_gator=("mesh", "lift"))
        res.append((b, rng.uniform()))
    (want, wnext), (got, gnext) = res
    assert gnext == wnext                      # the same draws, in order
    for k in ("pose2d", "lift_pose3d", "reg_pose3d", "mesh_valid",
              "lift_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mix", [("Human36M",), ("Human36M", "MuCo",
                                                 "AMASS")])
def test_pipeline_detector_noise_batches(mix, trees, both):
    """Training batches through both BatchPipelines (shuffled, mixed as the
    reference mixes), h36m detector noise, augmentation on: bit-equal on
    the Human36M rows, and within the SMPL pass's rounding elsewhere."""
    ja, pa, jsyn, psyn = both["human36"]
    jo, po = _opts("human36", use_gt_input=False, flip_enabled=True,
                   rotate_factor=30.0)
    root = trees["chip"]

    def make(mod, assets, opts):
        return [mod.DATASETS[n](assets, opts, root, "train") for n in mix]

    jp = jdata.BatchPipeline(make(jdata, ja, jo), jsyn, 16, seed=4,
                             drop_last=False, prefetch=0)
    pp = pdata.BatchPipeline(make(pdata, pa, po), psyn, 16, seed=4)
    assert len(pp) == len(jp)
    jit, pit = iter(jp), iter(pp)
    for _ in range(3):
        want, got = next(jit), next(pit)
        for k in want:
            g, w = _host(got[k]), np.asarray(want[k])
            if len(mix) == 1 and k != "mesh":
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, err_msg=k,
                    atol=1e-4 if k in ("pose2d", "mesh") else 0.1)
    jit.close()
    pit.close()


def _gt_and_pred(mesh_mm, seed):
    pred = mesh_mm + np.random.default_rng(seed).normal(0, 20, mesh_mm.shape)
    return pred.astype(np.float32)


@pytest.mark.parametrize("case,all_cameras", [("h36m_test_det", False),
                                              ("h36m_train_noise", True),
                                              ("h36m_train_noise", False)])
def test_h36m_evaluate_matches(case, all_cameras, trees, both, capsys):
    jd, pd, jsyn, _ = _readers(case, trees, both)
    t = jd.table
    gt, _ = jsyn.smpl_mesh_cam(t.pose, t.shape, t.trans, t.cam_r, t.cam_t)
    gt = np.asarray(gt, np.float32)
    pred = _gt_and_pred(gt, 1)
    want = jd.evaluate(pred, gt, verbose=True, all_cameras=all_cameras)
    jax_lines = capsys.readouterr().out
    got = pd.evaluate(torch.tensor(pred), torch.tensor(gt), verbose=True,
                      all_cameras=all_cameras)
    assert set(got) == set(want) == {"mpjpe", "pa_mpjpe", "smpl_mpjpe",
                                     "mpvpe"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # the same per-action report, to its two decimals
    assert capsys.readouterr().out.count("\n") == jax_lines.count("\n")
    assert pd.evaluate(gt, gt, verbose=False)["mpvpe"] == 0.0
    pj = np.einsum("jv,bvc->bjc", jd.assets.j_regressor_h36m, pred)
    gj = np.einsum("jv,bvc->bjc", jd.assets.j_regressor_h36m, gt)
    want = jd.evaluate_joint(pj, gj, verbose=False)
    got = pd.evaluate_joint(pj, gj, verbose=True)
    assert set(got) == set(want) == {"mpjpe", "pa_mpjpe"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["pw3d_det", "pw3d_jaxtree"])
def test_pw3d_evaluate_matches(case, trees, both):
    jd, pd, jsyn, psyn = _readers(case, trees, both)
    idx = np.arange(len(jd))
    gt = jd.synthesize_gt(idx, jsyn)
    got_gt = pd.synthesize_gt(idx, psyn)
    assert set(jd.table.gender.tolist()) == {1, 2}
    np.testing.assert_allclose(_host(got_gt) / 1000.0, gt / 1000.0,
                               atol=1e-4, rtol=0)
    pred = _gt_and_pred(gt, 2)
    want = jd.evaluate(pred, gt, verbose=False)
    got = pd.evaluate(pred, gt, verbose=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    zero = pd.evaluate(got_gt, got_gt, verbose=False)
    assert zero["mpjpe"] == zero["mpvpe"] == 0.0
    seqs = [(pred[:4, :17], gt[:4, :17]), (pred[3:], gt[3:])]
    np.testing.assert_allclose(pd.accel_errors(seqs), jd.accel_errors(seqs),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["COCO", "MuCo"])
def test_stand_in_tables_match(name, both):
    """The COCO/MuCo stand-ins: the seeded draws bit-equal, the keypoints
    regressed from the SMPL pass within rtol 1e-4."""
    from gator_tpu.data import synthetic as jsyn_mod
    from gator_tpu_torch.data import synthetic as psyn_mod

    ja, pa, jsyn, psyn = both["coco"]
    jo, po = _opts("coco", use_gt_input=False)
    fn = {"COCO": "synthetic_coco_dataset",
          "MuCo": "synthetic_muco_dataset"}[name]
    jd = getattr(jsyn_mod, fn)(ja, jo, n=20, seed=3, synthesizer=jsyn)
    pd = getattr(psyn_mod, fn)(pa, po, n=20, seed=3, synthesizer=psyn)
    assert type(pd) is pdata.DATASETS[name]
    assert pd.opts == pdata.ProcessOptions(**jd.opts.__dict__)
    exact = ("pose", "shape", "cam_s", "cam_t", "trans", "focal", "princpt",
             "joint_valid")
    for f in dataclasses.fields(jd.table):
        g, w = getattr(pd.table, f.name), getattr(jd.table, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if f.name in exact:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f.name)


def test_build_datasets_by_name(trees, both, monkeypatch):
    """cli.common.build_datasets reads every dataset name from
    $GATOR_DATA_DIR as the JAX package's does, and swaps each for its
    stand-in with synthetic=True."""
    monkeypatch.setenv("GATOR_DATA_DIR", trees["chip"])
    path = os.path.join(ROOT, "configs", "gator_synthetic_flagship.yml")
    cfg, jcfg = load_config(path), jload_config(path)
    ja, pa, jsyn, psyn = both["coco"]
    names = ("Human36M", "COCO", "MuCo", "AMASS", "Synthetic")
    got = pcommon.build_datasets(cfg, pa, names, True, synthetic_n=8,
                                 synthesizer=psyn)
    want = jcommon.build_datasets(jcfg, ja, names, True, synthetic_n=8,
                                  synthesizer=jsyn)
    assert [type(d).__name__ for d in got] == \
        [type(d).__name__ for d in want] == \
        ["Human36M", "CocoDataset", "MucoDataset", "AmassDataset",
         "SyntheticDataset"]
    assert [len(d) for d in got] == [len(d) for d in want]
    (test,) = pcommon.build_datasets(cfg, pa, ["PW3D"], False)
    assert type(test) is pdata.PW3D and len(test) == 12
    stand = pcommon.build_datasets(cfg, pa, names, True, synthetic_n=8,
                                   synthetic=True, synthesizer=psyn)
    assert [type(d).__name__ for d in stand] == \
        ["SyntheticDataset", "CocoDataset", "MucoDataset",
         "SyntheticDataset", "SyntheticDataset"]
    with pytest.raises(ValueError, match="unknown dataset"):
        pcommon.build_datasets(cfg, pa, ["Nope"], True)
    monkeypatch.setenv("GATOR_DATA_DIR", os.path.join(trees["chip"], "no"))
    monkeypatch.chdir(trees["chip"])
    with pytest.raises(FileNotFoundError, match="data directories"):
        pcommon.build_datasets(cfg, pa, ["COCO"], True)


def test_pipeline_closed_mid_epoch_stops_its_worker(trees, both):
    """Leaving a BatchPipeline's iterator mid-epoch waits for its prefetch
    worker, so no batch is still being made on the host after the close
    (a step timed after it would share the host with the worker)."""
    import threading

    ja, pa, jsyn, psyn = both["human36"]
    _, po = _opts("human36", use_gt_input=False)
    ds = pdata.Human36M(pa, po, trees["chip"], "train")
    before = threading.active_count()
    for _ in range(3):
        it = iter(pdata.BatchPipeline([ds], psyn, 4, seed=1))
        next(it)
        it.close()
        assert threading.active_count() == before


@pytest.mark.parametrize("stage", ["gator", "gat"])
def test_train_steps_take_pipeline_batches(stage, trees, both):
    """A reader's batch straight from BatchPipeline (host arrays beside the
    device mesh) feeds the train steps: the same losses and gradients as
    the batch given as tensors (the steps copy host leaves to the model's
    device)."""
    import copy

    from gator_tpu_torch import losses
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.train import (Adam, TrainState, make_gat_train_step,
                                       make_gator_train_step)

    _, pa, _, psyn = both["human36"]
    _, po = _opts("human36", use_gt_input=False)
    ds = pdata.Human36M(pa, po, trees["chip"], "train")
    it = iter(pdata.BatchPipeline([ds], psyn, 4, seed=2, stage=stage))
    batch = next(it)
    it.close()
    assert isinstance(batch["pose2d"], np.ndarray)
    model = build_gator(GatorSpec.from_assets(pa, embed_dim=64, depth=1),
                        seed=3, device="cpu")
    if stage == "gat":
        model = model.pose_lifter
        step = make_gat_train_step(model.spec)
    else:
        step = make_gator_train_step(model.spec, pa.faces,
                                     pa.j_regressor_h36m,
                                     losses.LossWeights())
    out = []
    for b in (batch, {k: torch.as_tensor(v) for k, v in batch.items()}):
        m = copy.deepcopy(model)
        state = TrainState(m, Adam(m.parameters(), lr=1e-3))
        loss = float(step(state, b, 0)["loss"])
        out.append((loss, [p.detach().clone() for p in m.parameters()]))
    assert np.isfinite(out[0][0]) and out[0][0] == out[1][0]
    for p, q in zip(out[0][1], out[1][1]):
        assert torch.equal(p, q)
