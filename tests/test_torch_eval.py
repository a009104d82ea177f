"""The port's eval path on the CPU against the JAX package on the same
inputs and weights (flax init -> `state_dict_from_jax`):
  * `load_config` on every configs/*.yml gives the JAX values; unknown keys
    raise;
  * `SyntheticDataset` batches through `BatchPipeline` (the prefetch thread
    on) equal the JAX ones for human36 and coco input: masks exact, the
    mesh within 1e-5 m, pose2d within 1e-5, reg_pose3d within 1e-5 of the
    camera-space scale (its joints are regressed from a mesh ~5 m away);
  * both eval steps per sample, errors within 1e-3 mm, predictions within
    1e-4 m (the serving tests' f32 bar);
  * `run_eval` over a ragged last batch gives the exact mean the JAX
    `run_eval` gives (rtol 1e-5);
  * a checkpoint round trip is exact.
"""
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from gator_tpu.config import load_config as jax_load_config
from gator_tpu.data import BatchPipeline as JaxBatchPipeline
from gator_tpu.data import GtSynthesizer as JaxGtSynthesizer
from gator_tpu.data import ProcessOptions as JaxProcessOptions
from gator_tpu.data import SyntheticDataset as JaxSyntheticDataset
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import GatSpec as JaxGatSpec
from gator_tpu.models import init_gat, init_gator
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import make_gat_eval_step as jax_gat_eval_step
from gator_tpu.train import make_gator_eval_step as jax_gator_eval_step
from gator_tpu.train import make_optimizer
from gator_tpu.train import run_eval as jax_run_eval
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.config import load_config
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.data import (BatchPipeline, GtSynthesizer,
                                  ProcessOptions, SyntheticDataset)
from gator_tpu_torch.models import GAT, GATOR, GatorSpec, GatSpec
from gator_tpu_torch.train import (load_checkpoint, load_weights,
                                   make_gat_eval_step, make_gator_eval_step,
                                   pick_checkpoint, run_eval,
                                   save_checkpoint)
from test_torch_convert import jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))
EVAL_JOINTS = {"human36": (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)}
N, BATCH = 40, 16        # three batches, the last ragged (8)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    assert dataclasses.asdict(load_config(path)) == \
        dataclasses.asdict(jax_load_config(path))


@pytest.mark.parametrize("bad", [{"TRAIN": {"no_such_key": 1}},
                                 {"NO_SUCH_SECTION": {}}, {"AUG": [1]}])
def test_load_config_rejects_unknown_keys(bad):
    with pytest.raises(ValueError):
        jax_load_config(None, overrides=bad)
    with pytest.raises(ValueError):
        load_config(None, overrides=bad)


def _pipelines(js, jassets, stage, shuffle, sizes=(N,)):
    """JAX and port pipelines over SyntheticDatasets of `sizes` (seeds 3,
    4, ...) -> (port assets, JAX datasets, port datasets, JAX pipeline,
    port pipeline)."""
    passets = build_assets(js, data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    jsyn = JaxGtSynthesizer(jassets)
    psyn = GtSynthesizer(passets, device="cpu")
    jds = [JaxSyntheticDataset(
        jassets, JaxProcessOptions(input_joint_name=js, is_train=False),
        n=n, seed=3 + i, synthesizer=jsyn) for i, n in enumerate(sizes)]
    pds = [SyntheticDataset(
        passets, ProcessOptions(input_joint_name=js, is_train=False), n=n,
        seed=3 + i, synthesizer=psyn) for i, n in enumerate(sizes)]
    jpipe = JaxBatchPipeline(jds, jsyn, BATCH, shuffle=shuffle, seed=5,
                             stage=stage, prefetch=0, drop_last=False)
    ppipe = BatchPipeline(pds, psyn, BATCH, shuffle=shuffle, seed=5,
                          stage=stage)
    return passets, jds, pds, jpipe, ppipe


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("js,layout", [("human36", "one"), ("coco", "one"),
                                       ("human36", "gendered"),
                                       ("coco", "two datasets")])
def test_synthetic_batches_match_jax(js, layout, small_assets,
                                     small_assets_coco):
    """gendered: rows of all three genders, so each batch synthesises in
    three groups and merges them on the device; two datasets: the
    reference's mixed sampling (an epoch of 2 x 40 slots), each batch
    assembled per dataset and merged back in slot order."""
    jassets = {"human36": small_assets, "coco": small_assets_coco}[js]
    sizes = (N, 24) if layout == "two datasets" else (N,)
    _, jds, pds, jpipe, ppipe = _pipelines(js, jassets, "gator", True,
                                           sizes)
    if layout == "gendered":
        jds[0].table.gender = pds[0].table.gender = np.arange(N) % 3
    for jd, pd in zip(jds, pds):
        for f in ("pose", "shape", "trans", "cam_r", "cam_t", "focal",
                  "princpt", "gender"):
            np.testing.assert_array_equal(getattr(pd.table, f),
                                          getattr(jd.table, f))
    scale = np.abs(jds[0].table.joint_cam_h36m).max()       # ~5000 mm
    for jd, pd in zip(jds, pds):
        np.testing.assert_allclose(pd.table.joint_cam_h36m,
                                   jd.table.joint_cam_h36m,
                                   atol=1e-5 * scale)
    jpipe.set_epoch(1)
    ppipe.set_epoch(1)
    got, want = list(ppipe), list(jpipe)
    assert [len(b["pose2d"]) for b in got] == (
        [16] * 5 if layout == "two datasets" else [16, 16, 8])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert isinstance(g["mesh"], torch.Tensor)      # stays on device
        for k in ("mesh_valid", "reg_valid", "lift_valid"):
            np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)
        np.testing.assert_allclose(_np(g["mesh"]), _np(w["mesh"]),
                                   atol=1e-5)
        np.testing.assert_allclose(g["pose2d"], _np(w["pose2d"]),
                                   atol=1e-5)
        for k in ("reg_pose3d", "lift_pose3d"):
            np.testing.assert_allclose(g[k], _np(w[k]), atol=1e-5 * scale,
                                       err_msg=k)


@pytest.fixture(scope="module", params=["human36", "coco"])
def gator_case(request, small_assets, small_assets_coco):
    """JAX eval over the JAX pipeline (per sample, and run_eval) and the
    port's model with the same weights and pipeline."""
    js = request.param
    jassets = {"human36": small_assets, "coco": small_assets_coco}[js]
    alpha = js == "coco"
    passets, _, _, jpipe, ppipe = _pipelines(js, jassets, "gator", False)
    jspec = JaxGatorSpec.from_assets(jassets, embed_dim=64, depth=2,
                                     alpha=alpha)
    variables = jax_variables(init_gator, jspec, 4)
    if not alpha:
        rng = np.random.default_rng(4)
        bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    state = JaxTrainState.create(variables, make_optimizer("adam", 1e-3))
    eval_joints = EVAL_JOINTS["human36"]
    jstep = jax_gator_eval_step(jspec, jassets.j_regressor_h36m, eval_joints)
    jitted = jax.jit(jstep)
    batches = [jax.tree_util.tree_map(np.asarray, b) for b in jpipe]
    outs = [jax.tree_util.tree_map(np.asarray, jitted(state, b))
            for b in batches]
    jres = jax_run_eval(jstep, state, jpipe)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=64, depth=2,
                                        alpha=alpha))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    step = make_gator_eval_step(passets.j_regressor_h36m, eval_joints)
    return {"batches": batches, "outs": outs, "jres": jres,
            "model": model.eval(), "step": step, "pipe": ppipe}


def test_gator_eval_step_matches_jax(gator_case):
    c = gator_case
    for batch, want in zip(c["batches"], c["outs"]):
        got = c["step"](c["model"], batch)
        for k in ("joint_err", "surface_err"):
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-3,
                                       rtol=0, err_msg=k)
        for k in ("pred_mesh_mm", "pred_pose_mm"):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=0.1,
                                       rtol=0, err_msg=k)


def test_run_eval_ragged_mean_matches_jax(gator_case):
    c = gator_case
    res = run_eval(c["step"], c["model"], c["pipe"],
                   collect_out=("pred_mesh_mm",), collect_batch=("mesh",))
    assert res["count"] == c["jres"]["count"] == N
    per_sample = np.concatenate([o["joint_err"] for o in c["outs"]])
    for k in ("joint_err", "surface_err"):
        np.testing.assert_allclose(res[k], c["jres"][k], rtol=1e-5)
    # the exact per-sample mean, not the mean of the three batch means
    np.testing.assert_allclose(res["joint_err"], per_sample.mean(),
                               rtol=1e-5)
    assert res["pred_mesh_mm"].shape == res["mesh"].shape == (N, 890, 3)
    with pytest.raises(ValueError, match="overlap"):
        run_eval(c["step"], c["model"], [], collect_out=("mesh",),
                 collect_batch=("mesh",))


def test_gat_eval_step_matches_jax(small_assets):
    _, _, _, jpipe, ppipe = _pipelines("human36", small_assets, "gat",
                                       False)
    jspec = JaxGatSpec.from_assets(small_assets, embed_dim=64, depth=2)
    variables = jax_variables(init_gat, jspec, 6)
    state = JaxTrainState.create(variables, make_optimizer("adam", 1e-3))
    eval_joints = EVAL_JOINTS["human36"]
    jstep = jax_gat_eval_step(jspec, eval_joints)
    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    model = GAT(GatSpec.from_assets(passets, embed_dim=64, depth=2))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    step = make_gat_eval_step(eval_joints)
    jitted = jax.jit(jstep)
    for batch in jpipe:
        batch = jax.tree_util.tree_map(np.asarray, batch)
        want = jitted(state, batch)
        got = step(model.eval(), batch)
        np.testing.assert_allclose(got["joint_err"].numpy(),
                                   np.asarray(want["joint_err"]), atol=1e-3,
                                   rtol=0)
    res = run_eval(step, model, ppipe)
    jres = jax_run_eval(jstep, state, jpipe)
    assert res["count"] == jres["count"] == N
    np.testing.assert_allclose(res["joint_err"], jres["joint_err"],
                               rtol=1e-5)


def test_checkpoint_round_trip(tmp_path):
    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    spec = GatorSpec.from_assets(passets, embed_dim=64, depth=1)
    model = GATOR(spec)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    path = save_checkpoint(str(tmp_path), model, 3, optimizer=opt,
                           train_log=[1.5, 1.2], test_log={"mpjpe": [90.0]},
                           is_best=True)
    assert path.endswith("checkpoint3.pth.tar")
    save_checkpoint(str(tmp_path), model, 5)
    payload = load_checkpoint(path)
    assert payload["epoch"] == 3 and payload["train_log"] == [1.5, 1.2]
    assert set(payload) == {"epoch", "model_state_dict", "optim_state_dict",
                            "scheduler_state_dict", "train_log", "test_log"}
    assert pick_checkpoint(str(tmp_path)).endswith("checkpoint5.pth.tar")
    assert pick_checkpoint(str(tmp_path), pick_best=True).endswith(
        "best.pth.tar")
    save_checkpoint(str(tmp_path), model, 4, is_final=True)
    assert pick_checkpoint(str(tmp_path)).endswith("checkpoint5.pth.tar")
    for source in (path, str(tmp_path)):
        fresh = load_weights(GATOR(spec), source)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
    # the reference's DataParallel layout loads too
    ref = tmp_path / "ref.pth.tar"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                     model.state_dict().items()}}, ref)
    fresh = load_weights(GATOR(spec), str(ref))
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in model.state_dict().items())


class _Rows:
    """A stand-in dataset: batch k of a pipeline is {"pose2d": its rows};
    the batch holding row `fail_at` raises in the worker."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def make_batch(self, idx, synth, rng, stage):
        if self.fail_at is not None and self.fail_at in idx:
            raise KeyError(f"row {self.fail_at}")
        return {"pose2d": np.asarray(idx)}


def test_pipeline_relays_worker_errors_and_stops_when_left():
    import threading
    import time

    pipe = BatchPipeline([_Rows(40, fail_at=20)], None, BATCH,
                         shuffle=False)
    got = []
    with pytest.raises(KeyError, match="row 20"):
        for batch in pipe:
            got.append(batch["pose2d"])
    assert [len(b) for b in got] == [16]        # the batch before the error
    before = threading.active_count()
    it = iter(BatchPipeline([_Rows(4000)], None, BATCH, shuffle=False))
    np.testing.assert_array_equal(next(it)["pose2d"], np.arange(16))
    it.close()          # leaving mid-epoch unblocks and stops the worker
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
