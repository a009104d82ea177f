"""The port's three CLIs at world 2 (2 gloo ranks on the CPU through
`parallel.spawn`) against world 1, and the data-parallel dry run.

- `cli.train` on gator_synthetic_smoke-sized data (48 samples, a global
  batch of 16, two epochs, the config's dropout rates): rank 0 alone
  writes each checkpoint, and the final one equals a world-1 run's after
  the same steps (rtol 1e-5; SGD, whose update is linear in the gradient,
  so the ranks' f32 sum order is not amplified as by Adam's first steps);
- SIGTERM sent to rank 1 alone at the start of epoch 2 stops both ranks
  after the same step (1), rank 0 writes checkpoint1 once, and
  --resume_training then ends bit-equal to the uninterrupted world-2 run;
- `cli.test` prints the MPVPE / MPJPE line world 1 prints, over a ragged
  41-sample test set; `cli.serve` rounds its batch up to a multiple of 2,
  prints the rate with the world size on rank 0 alone and writes the
  meshes world 1 writes (within 1e-5 m);
- `dryrun_multigpu(2, device="cpu")` prints a line that says ok.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import serve as serve_cli
from gator_tpu_torch.cli import test as test_cli
from gator_tpu_torch.cli import train as train_cli
from gator_tpu_torch.config import load_config
from gator_tpu_torch.parallel import spawn
from gator_tpu_torch.parallel.checks import run_cases
from gator_tpu_torch.parallel.dryrun import dryrun_multigpu
from gator_tpu_torch.train import load_checkpoint
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, V = 48, 890


@pytest.fixture(scope="module")
def passets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=V,
                        seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, passets):
    """The world-2 runs (one group of processes each) and their world-1
    counterparts in this process."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    with open(os.path.join(ROOT, "configs", "gator_synthetic_smoke.yml")) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"].update({"depth": 2, "embed_dim": 64})
    raw["TRAIN"].update({"batch_size": 16, "precision": "float32",
                         "edge_loss_start": 1, "print_freq": 100,
                         "optimizer": "sgd", "lr": 1e-3, "lr_step": [1],
                         "lr_factor": 0.5})
    raw["TEST"]["batch_size"] = 64
    cfg = tmp / "smoke.yml"
    cfg.write_text(yaml.safe_dump(raw))
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.uniform(50, 450, size=(13, 17, 2)),
                            rng.uniform(0.3, 1.0, size=(13, 17, 1))],
                           axis=2).astype(np.float32)
    np.save(tmp / "poses.npy", poses)

    def train(exp, **kw):
        return dict(cfg=str(cfg), exp_dir=str(tmp / exp), synthetic=True,
                    synthetic_n=N, epochs=2, device="cpu", assets=passets,
                    **kw)

    def serve(out):
        return dict(pose_path=str(tmp / "poses.npy"), joint_set="human36",
                    output=str(tmp / out), obj_dir=str(tmp / (out + "_obj")),
                    obj_every=5, batch_size=7, dtype="float32",
                    device="cpu", assets=passets)

    test = dict(cfg=str(cfg), synthetic=True, device="cpu", assets=passets,
                synthetic_n=41)
    two = spawn(run_cases, 2, args=([
        {"kind": "train_cli", "kwargs": train("two")},
        {"kind": "test_cli", "kwargs": test},
        {"kind": "serve_cli", "kwargs": serve("two.npy")}],), timeout=300)
    term = spawn(run_cases, 2, args=([
        {"kind": "train_cli", "kwargs": train("term"), "term_epoch": 2,
         "term_rank": 1},
        {"kind": "train_cli", "kwargs": train("term", resume=True)}],),
        timeout=300)
    one = run_cases(None, [
        {"kind": "train_cli", "kwargs": train("one")},
        {"kind": "test_cli", "kwargs": test},
        {"kind": "serve_cli", "kwargs": serve("one.npy")}])
    return {"tmp": tmp, "two": two, "term": term, "one": one}


def _ckpt(tmp, exp, name="final.pth.tar"):
    return load_checkpoint(str(tmp / exp / "checkpoint" / name))


def test_world2_train_writes_the_world1_checkpoints(runs):
    tmp = runs["tmp"]
    assert sorted(os.listdir(tmp / "two" / "checkpoint")) \
        == sorted(os.listdir(tmp / "one" / "checkpoint")) \
        == ["best.pth.tar", "checkpoint1.pth.tar", "final.pth.tar"]
    got, want = _ckpt(tmp, "two"), _ckpt(tmp, "one")
    assert got["step"] == want["step"] == 6 and got["epoch"] == 2
    np.testing.assert_allclose(got["train_log"], want["train_log"],
                               rtol=1e-5)
    for k in ("joint", "surface"):
        np.testing.assert_allclose(got["test_log"][k], want["test_log"][k],
                                   rtol=1e-5)
    for k, v in want["model_state_dict"].items():
        g = got["model_state_dict"][k]
        if v.is_floating_point():
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-8, err_msg=k)
        else:
            assert torch.equal(g, v), k
    # rank 0 alone prints; both ranks return the same best error
    r0, r1 = (r[0] for r in runs["two"])
    assert r0["result"] == r1["result"]
    assert "epoch 2 MPJPE" in r0["stdout"] and r1["stdout"] == ""
    assert "2 ranks" in r0["stdout"]


def test_sigterm_on_one_rank_stops_both_and_resumes_bit_equal(runs):
    tmp = runs["tmp"]
    (stop0, resume0), (stop1, _) = runs["term"]
    assert "preempted at epoch 2 step 1; checkpoint1 written" \
        in stop0["stdout"]
    assert "SIGTERM received" not in stop0["stdout"]
    assert "SIGTERM received" in stop1["stdout"]
    assert "rank 1: preempted at epoch 2 step 1" in stop1["stdout"]
    assert "resumed from epoch 1 (step 3)" in resume0["stdout"]
    # the state epoch 2 began with, written once by rank 0
    assert _ckpt(tmp, "term", "checkpoint1.pth.tar")["step"] == 3
    got, want = _ckpt(tmp, "term"), _ckpt(tmp, "two")
    assert got["step"] == want["step"] == 6
    assert got["train_log"] == want["train_log"]
    assert got["test_log"] == want["test_log"]
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    go, wo = got["optim_state_dict"], want["optim_state_dict"]
    for i, st in wo["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(go["state"][i][k], v), (i, k)


def test_world2_test_and_serve_print_and_write_what_world1_does(runs):
    tmp = runs["tmp"]
    (_, t0, s0), (_, t1, s1) = (r for r in runs["two"])
    _, t_one, s_one = runs["one"]

    def line(out, key):
        return [ln for ln in out.splitlines() if ln.startswith(key)]

    assert line(t0["stdout"], "MPVPE") == line(t_one["stdout"], "MPVPE")
    assert t1["stdout"] == ""
    out0, res0 = t0["result"]
    out1, res1 = t1["result"]
    _, res = t_one["result"]
    assert res0["count"] == res1["count"] == res["count"] == 41
    for k in ("joint_err", "surface_err"):
        np.testing.assert_allclose(res0[k], res[k], rtol=1e-6)
        assert res1[k] == res0[k]
    assert out0 == out1
    # serve: the batch rounded up, rank 0 alone prints and writes
    assert "batch_size rounded up to 8 (multiple of 2 ranks)" \
        in s0["stdout"]
    assert "x 2 ranks" in s0["stdout"] and s1["stdout"] == ""
    assert line(s0["stdout"], "meshes ->")[0].replace("two", "one") \
        == line(s_one["stdout"], "meshes ->")[0]
    got, want = np.load(tmp / "two.npy"), np.load(tmp / "one.npy")
    assert got.shape == want.shape == (13, V, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(s1["result"]["meshes"], want, atol=1e-5,
                               rtol=0)
    assert sorted(os.listdir(tmp / "two.npy_obj")) \
        == sorted(os.listdir(tmp / "one.npy_obj"))


def test_dryrun_multigpu_on_two_cpu_ranks(capsys):
    line = dryrun_multigpu(2, device="cpu")
    assert line.startswith("dryrun_multigpu(2): ok, loss=")
    assert "k_step_scan=not ported" in line
    assert "world=2 ranks over gloo on cpu" in line
    assert line in capsys.readouterr().out


def test_the_entry_points_run_world_1_without_torchrun(monkeypatch):
    """No torchrun variables: each CLI's `main` takes world 1 and no
    process group (their parsers are unchanged)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    seen = []
    for mod, name in ((train_cli, "run_train"), (test_cli, "run_test"),
                      (serve_cli, "run_serve")):
        monkeypatch.setattr(mod, name, lambda *a, world=None, **k: seen.append(
            (world.size, world.grouped, str(world.device))) or (None, None))
    cfg = os.path.join(ROOT, "configs", "gator_synthetic_smoke.yml")
    train_cli.main(["--cfg", cfg, "--device", "cpu"])
    test_cli.main(["--cfg", cfg, "--device", "cpu"])
    serve_cli.main(["--input_poses", "p.npy", "--device", "cpu"])
    assert seen == [(1, False, "cpu")] * 3
    assert load_config(cfg).TRAIN.batch_size == 16
