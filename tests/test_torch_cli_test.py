"""The port's eval CLI (`gator_tpu_torch.cli.test`) on the CPU against the
JAX package's `Session` + `run_eval` on the same weights (flax init ->
`state_dict_from_jax` -> a checkpoint file the CLI loads) and the same
small assets (890 vertices): MPJPE and MPVPE within rtol 1e-5, for a
human36 GATOR (alpha False), a coco-input GATOR (alpha True) and a GAT
config. The configs are the repo's, cut to depth 2 and a test batch of 16
over 40 synthetic samples (a ragged last batch).
"""
import os

import numpy as np
import pytest
import torch
import yaml

from gator_tpu.cli.common import Session as JaxSession
from gator_tpu.config import load_config as jax_load_config
from gator_tpu.models import init_gat, init_gator
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import run_eval as jax_run_eval
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import common as cli_common
from gator_tpu_torch.cli import test as test_cli
from gator_tpu_torch.config import load_config
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.train import save_checkpoint
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from torch_fixtures import write_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 40
CASES = {
    "gator_human36": ("gator_synthetic_smoke.yml", {}),
    "gator_coco_alpha": ("gator_synthetic_smoke.yml",
                         {"DATASET": {"input_joint_set": "coco"},
                          "MODEL": {"alpha": True}}),
    "gat_human36": ("gat_synthetic_e2e.yml", {}),
}


def _config(tmp_path, name, extra, vis=False):
    """The repo's config `name` cut to size (depth 2, test batch 16), with
    `extra` on top, written to a yaml both packages read."""
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"].update({"depth": 2, **extra.get("MODEL", {})})
    raw["DATASET"].update(extra.get("DATASET", {}))
    raw["TEST"].update({"batch_size": 16, "vis": vis})
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    # the JAX Session turns on XLA's persistent cache: keep it in tmp_path
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_session(case, tmp_path, jax_cache, small_assets,
                                 small_assets_coco):
    name, extra = CASES[case]
    cfg_path = _config(tmp_path, name, extra)
    jcfg = jax_load_config(cfg_path)
    js = jcfg.DATASET.input_joint_set
    jassets = {"human36": small_assets, "coco": small_assets_coco}[js]
    sess = JaxSession(jcfg, is_train=False, synthetic=True, assets=jassets,
                      synthetic_n=N)
    variables = jax_variables(init_gator if sess.is_gator else init_gat,
                              sess.spec, 7)
    _, eval_step = sess.make_steps(sess.make_optimizer())
    want = jax_run_eval(eval_step, JaxTrainState.create(
        variables, sess.make_optimizer()), sess.pipeline)

    weights = tmp_path / "weights.pth.tar"
    torch.save({"epoch": 1,
                "model_state_dict": state_dict_from_jax(variables)}, weights)
    passets = build_assets(js, data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    out, got = test_cli.run_test(load_config(cfg_path), str(weights),
                                 synthetic=True, device="cpu",
                                 assets=passets, synthetic_n=N)
    assert got["count"] == want["count"] == N
    keys = ("joint_err", "surface_err") if sess.is_gator else ("joint_err",)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert out == {"mpjpe": got["joint_err"]}


def test_cli_main_prints_returns_and_dumps(tmp_path, monkeypatch, capsys):
    """`main` with the CLI's own arguments: the prints and the return value
    of the JAX CLI, random weights from the seed unless --weights, and the
    TEST.vis .obj dumps."""
    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    monkeypatch.setattr(cli_common, "build_assets",
                        lambda *a, **k: passets)
    cfg_path = _config(tmp_path, "gator_synthetic_smoke.yml", {}, vis=True)
    vis_dir = tmp_path / "vis"
    out = test_cli.main(["--cfg", cfg_path, "--synthetic", "--device", "cpu",
                         "--vis_dir", str(vis_dir)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "WARNING: evaluating randomly initialized weights"
    assert lines[1].startswith("MPVPE: ") and ", MPJPE: " in lines[1]
    # Synthetic has no metric suite, and TEST.vis dumps inside the suite
    # (as in the JAX CLI): nothing more is printed or written
    assert len(lines) == 2 and not vis_dir.exists()
    assert set(out) == {"mpjpe"} and np.isfinite(out["mpjpe"])
    assert float(lines[1].split("MPJPE: ")[1]) == round(out["mpjpe"], 2)
    # the same run from a checkpoint of those random weights
    sess = cli_common.Session(load_config(cfg_path), synthetic=True,
                              device="cpu")
    weights = tmp_path / "w.pth.tar"
    torch.save(sess.build_model().state_dict(), weights)
    again = test_cli.main(["--cfg", cfg_path, "--synthetic", "--device",
                           "cpu", "--weights", str(weights), "--vis_dir",
                           str(vis_dir)])
    assert capsys.readouterr().out.startswith(
        f"loaded weights from {weights}")
    assert again == out


SUITE_CASES = {
    # config, JAX init, eval collection, the suite's keys
    "h36m_det": ("gator_human36J_test_human36_det.yml", init_gator,
                 ("pred_mesh_mm", "mesh"),
                 {"mpjpe", "pa_mpjpe", "smpl_mpjpe", "mpvpe"}),
    "gat_h36m_det": ("gat_human36J_train_human36.yml", init_gat,
                     ("pred_pose_mm", "joint_cam"), {"mpjpe", "pa_mpjpe"}),
}


@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_run_test_metric_suite_matches_jax_cli(case, tmp_path, jax_cache,
                                               monkeypatch, capsys,
                                               small_assets,
                                               small_assets_coco):
    """`run_test` on a fabricated dataset tree (tests/torch_fixtures.py)
    read through $GATOR_DATA_DIR, with weights that gator_tpu saved and
    tools/jax_checkpoint_to_torch.py converted: the dataset's metric suite
    (Human36M's per-action protocol-2 report; `evaluate_joint` for the GAT
    lifter) equals the JAX CLI's figures on the same checkpoint within rtol
    1e-5, and TEST.vis dumps every 10th mesh. 3DPW's suite is held to the
    JAX package's in tests/test_torch_readers.py."""
    from test_torch_checkpoint_convert import _save, _tool

    name, init, (pred_key, gt_key), keys = SUITE_CASES[case]
    data = tmp_path / "data"
    write_fixtures(str(data), h36m_test=40, h36m_train=0, pw3d=20, coco=0,
                   muco=0, seed=5)
    monkeypatch.setenv("GATOR_DATA_DIR", str(data))
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["depth"] = 2
    raw["TEST"].update({"batch_size": 16, "vis": True, "weight_path": ""})
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))

    jcfg = jax_load_config(str(cfg_path))
    js = jcfg.DATASET.input_joint_set
    jassets = {"human36": small_assets, "coco": small_assets_coco}[js]
    sess = JaxSession(jcfg, is_train=False, assets=jassets)
    variables = jax_variables(init, sess.spec, 7)
    ckpt = str(tmp_path / "ckpt")
    _save(ckpt, variables, 2, is_best=True)
    weights = str(tmp_path / "best.pth.tar")
    _tool().convert(ckpt, weights)
    _, eval_step = sess.make_steps(sess.make_optimizer())
    res = jax_run_eval(eval_step, JaxTrainState.create(
        variables, sess.make_optimizer()), sess.pipeline,
        collect_out=(pred_key,), collect_batch=(gt_key,))
    ds = sess.datasets[0]
    scale = 1000.0 if gt_key == "mesh" else 1.0
    suite = ds.evaluate if gt_key == "mesh" else ds.evaluate_joint
    want = suite(res[pred_key][:len(ds)], res[gt_key][:len(ds)] * scale,
                 verbose=False)
    capsys.readouterr()

    passets = build_assets(js, data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    vis_dir = tmp_path / "vis"
    out, got = test_cli.run_test(load_config(str(cfg_path)), weights,
                                 device="cpu", assets=passets,
                                 vis_dir=str(vis_dir))
    printed = capsys.readouterr().out
    assert got["count"] == res["count"] == len(ds) > 16
    np.testing.assert_allclose(got["joint_err"], res["joint_err"],
                               rtol=1e-5)
    assert set(out) == set(want) == keys
    for k in keys:
        np.testing.assert_allclose(out[k], want[k], rtol=1e-5, err_msg=k)
    if gt_key == "mesh":
        n_obj = len(range(0, len(ds), 10))
        assert f"dumped {n_obj} meshes to {vis_dir}" in printed
        assert len(os.listdir(vis_dir)) == n_obj
    else:
        assert not vis_dir.exists()
    assert "PA-MPJPE" in printed and "Directions: " in printed


@pytest.mark.parametrize("name,debug", [
    ("gator_human36J_test_human36_det.yml", False),
    ("gator_human36J_test_human36_gt.yml", True)])
def test_cli_main_on_fabricated_h36m_tree(name, debug, tmp_path, monkeypatch,
                                          capsys):
    """`python -m gator_tpu_torch.cli.test --cfg
    configs/gator_human36J_test_human36_det.yml --device cpu` (cut to depth
    2) on a fabricated tree through $GATOR_DATA_DIR, with the weights at
    the config's TEST.weight_path (a directory of checkpoints, as the
    configs name it): the per-action protocol-2 report. A TEST.weight_path
    that does not exist raises, as in the JAX CLI. --debug (GT input: the
    detections file covers every test subject, and the reader, like the JAX
    package's, matches it by count) keeps the first test subject."""

    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    monkeypatch.setattr(cli_common, "build_assets", lambda *a, **k: passets)
    data = tmp_path / "data"
    write_fixtures(str(data), h36m_test=30, h36m_train=0, pw3d=0, coco=0,
                   muco=0, seed=6)
    monkeypatch.setenv("GATOR_DATA_DIR", str(data))
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["depth"] = 2
    raw["TEST"]["weight_path"] = str(tmp_path / "results" / "h36m")
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    argv = ["--cfg", str(cfg_path), "--device", "cpu"]
    cfg = load_config(str(cfg_path))
    with pytest.raises(FileNotFoundError):
        test_cli.run_test(cfg, device="cpu", debug=debug)
    model = build_gator(GatorSpec.from_assets(
        passets, embed_dim=cfg.MODEL.embed_dim, depth=2,
        alpha=cfg.MODEL.alpha), seed=3, device="cpu")
    save_checkpoint(cfg.TEST.weight_path, model, 1, is_best=True)
    capsys.readouterr()
    out, res = test_cli.run_test(cfg, device="cpu", debug=debug)
    capsys.readouterr()
    assert res["count"] == (14 if debug else 28)    # one row has no fit
    assert out == test_cli.main(argv + ["--debug"] * debug)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"loaded weights from {cfg.TEST.weight_path}"
    assert lines[1].startswith("MPVPE: ")
    assert lines[2].startswith("Protocol 2 H36M pose error (MPJPE) >> tot: ")
    assert lines[3].startswith("Directions: ")
    assert lines[4].startswith(
        "Protocol 2 H36M pose error (PA-MPJPE) >> tot: ")
    assert lines[-1].startswith("SMPL MPJPE: ")
    assert set(out) == {"mpjpe", "pa_mpjpe", "smpl_mpjpe", "mpvpe"}
    assert all(np.isfinite(v) for v in out.values())
