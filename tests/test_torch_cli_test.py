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
from test_torch_convert import jax_variables

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
    assert lines[2] == f"dumped 26 meshes to {vis_dir}"   # 256 samples
    assert set(out) == {"mpjpe"} and np.isfinite(out["mpjpe"])
    assert float(lines[1].split("MPJPE: ")[1]) == round(out["mpjpe"], 2)
    obj = (vis_dir / "eval_000250.obj").read_text().splitlines()
    assert sum(ln.startswith("v ") for ln in obj) == 890
    assert sum(ln.startswith("f ") for ln in obj) == len(passets.faces)
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
