"""The port's demo CLI (`gator_tpu_torch.cli.demo`) on the CPU against the
JAX package's (`gator_tpu.cli.demo.run_demo`) on the same pose, weights and
small assets (890 vertices), for the coco and human36 joint sets: the mesh
within 1e-4 m, the closed-form camera within rtol 1e-4, the written .obj's
vertices within 1e-4 and its faces equal, both PNGs written (cv2 is a
test dependency); without cv2 the PNGs are skipped and the printed line
says so; with --adam_fit from the JAX package's own start, the camera
within 1e-3 (the fit's last learning rate; tests/test_torch_camera_vis.py).

The weights are one flax init per joint set, converted with
`state_dict_from_jax` and saved as a reference-layout .pth.tar that both
demos load through their `weights` argument. Both demos build their model
from `GatorSpec.from_assets` at depth 2 (the class is patched in both
modules; the full depth 6 runs on the card in
tests/test_torch_paths_cuda.py), and the JAX demo's own init, whose every
leaf the weights replace, returns the cached init: each flax init compiles
for ~9 s on one core.
"""
import functools
import sys
import types

import jax
import numpy as np
import pytest
import torch

from gator_tpu.assets import build_assets as jax_build_assets
from gator_tpu.cli import demo as jdemo
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import demo
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GatorSpec
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

DEPTH = 2
# the fabricated COCO pose of tests/test_coverage_extras.py:61-66
BASE = np.array(
    [[500, 180], [520, 160], [480, 160], [545, 170], [455, 170],
     [580, 260], [420, 260], [610, 380], [390, 380], [630, 490],
     [370, 490], [560, 520], [440, 520], [565, 700], [435, 700],
     [570, 880], [430, 880]], np.float32)


def _shallow(spec_cls):
    return types.SimpleNamespace(from_assets=functools.partial(
        spec_cls.from_assets, depth=DEPTH))


@pytest.fixture(scope="module")
def pose_path(tmp_path_factory):
    rng = np.random.default_rng(1234)
    pose = np.concatenate(
        [BASE + rng.normal(0, 5, (17, 2)).astype(np.float32),
         np.ones((17, 1), np.float32)], 1)
    path = str(tmp_path_factory.mktemp("pose") / "pose.npy")
    np.save(path, pose)
    return path


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """joint set -> (JAX assets, port assets, flax init, weights path)."""
    out = {}
    for joint_set in ("coco", "human36"):
        jassets = jax_build_assets(joint_set, data_dirs=[],
                                   synthetic_vertex_num=890, seed=0)
        variables = jax_variables(
            init_gator, JaxGatorSpec.from_assets(jassets, depth=DEPTH), 0)
        path = str(tmp_path_factory.mktemp(joint_set) / "w.pth.tar")
        torch.save({"epoch": 0,
                    "model_state_dict": state_dict_from_jax(variables)},
                   path)
        out[joint_set] = (jassets, build_assets(
            joint_set, data_dirs=[], synthetic_vertex_num=890, seed=0),
            variables, path)
    return out


@pytest.fixture
def shallow(monkeypatch):
    monkeypatch.setattr(jdemo, "GatorSpec", _shallow(JaxGatorSpec))
    monkeypatch.setattr(demo, "GatorSpec", _shallow(GatorSpec))


def _run_both(monkeypatch, tmp_path, setups, pose_path, joint_set, **kw):
    jassets, passets, variables, weights = setups[joint_set]
    monkeypatch.setattr(jdemo, "init_gator", lambda spec, key: variables)
    # only the port's images are checked here; the renderer is held
    # pixel-equal to the JAX one in tests/test_torch_camera_vis.py
    monkeypatch.setattr(jdemo, "render_mesh_overlay", lambda img, *a: img)
    want = jdemo.run_demo(pose_path, joint_set, weights,
                          str(tmp_path / "jax"), assets=jassets, **kw)
    got = demo.run_demo(pose_path, joint_set, weights,
                        str(tmp_path / "port"), assets=passets,
                        device="cpu", **kw)
    return got, want


def _obj(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    verts = np.array([r[1:] for r in rows if r[0] == "v"], np.float64)
    faces = np.array([r[1:] for r in rows if r[0] == "f"], np.int64)
    return verts, faces


@pytest.mark.parametrize("joint_set", ["coco", "human36"])
def test_demo_matches_jax(joint_set, tmp_path, monkeypatch, shallow, setups,
                          pose_path):
    got, want = _run_both(monkeypatch, tmp_path, setups, pose_path,
                          joint_set)
    assert got["mesh"].shape == (890, 3)
    np.testing.assert_allclose(got["mesh"], want["mesh"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["cam"].s, np.asarray(want["cam"].s),
                               rtol=1e-4)
    np.testing.assert_allclose(got["cam"].t, np.asarray(want["cam"].t),
                               rtol=1e-4, atol=1e-6)
    verts, faces = _obj(got["obj_path"])
    jverts, jfaces = _obj(want["obj_path"])
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(faces, jfaces)
    for name in demo.IMAGES:
        assert (tmp_path / "port" / name).stat().st_size > 0


def test_demo_adam_fit_matches_jax(tmp_path, monkeypatch, shallow, setups,
                                   pose_path):
    """--adam_fit from the JAX package's uniform draw (`init=`, the fit's
    test seam). The port's render, checked above, is stubbed here: at this
    camera the synthetic mesh's random faces take it ~7 s."""
    init = np.array(jax.random.uniform(jax.random.PRNGKey(0), (1, 3)))
    monkeypatch.setattr(demo, "render_mesh_overlay", lambda img, *a: img)
    monkeypatch.setattr(demo, "fit_camera_adam", functools.partial(
        demo.fit_camera_adam, init=torch.from_numpy(init)))
    got, want = _run_both(monkeypatch, tmp_path, setups, pose_path, "coco",
                          adam_fit=True)
    np.testing.assert_allclose(got["mesh"], want["mesh"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["cam"].s, np.asarray(want["cam"].s),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["cam"].t, np.asarray(want["cam"].t),
                               rtol=0, atol=1e-3)


def test_demo_main_without_cv2(tmp_path, monkeypatch, capsys, setups,
                               pose_path):
    """`main` with its flags and the model at full depth: where cv2 does not
    import, the mesh and the camera are computed as before, the .obj is
    written, the PNGs are not, and one line names them and the reason."""
    passets = setups["human36"][1]
    monkeypatch.setattr(demo, "build_assets", lambda joint_set: passets)
    out_dir = tmp_path / "out"
    argv = ["--input_pose", pose_path, "--joint_set", "human36",
            "--output_dir", str(out_dir), "--device", "cpu"]
    with_cv2 = demo.main(argv)
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "demo_mesh.obj", *demo.IMAGES]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("camera fit: s=") and "px" in lines[0]
    assert lines[1] == f"results saved in {out_dir}"

    monkeypatch.setitem(sys.modules, "cv2", None)
    out_dir2 = tmp_path / "out2"
    without = demo.main(argv[:-4] + ["--output_dir", str(out_dir2),
                                     "--device", "cpu"])
    assert sorted(p.name for p in out_dir2.iterdir()) == ["demo_mesh.obj"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith(
        "skipped demo_mesh.png and demo_pose2d.png: cv2 is not installed")
    assert lines[2] == f"results saved in {out_dir2}"
    np.testing.assert_array_equal(without["mesh"], with_cv2["mesh"])
    assert torch.equal(without["cam"].s, with_cv2["cam"].s)
    assert (out_dir2 / "demo_mesh.obj").read_text() == (
        out_dir / "demo_mesh.obj").read_text()
