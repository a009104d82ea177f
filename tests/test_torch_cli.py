"""The port's serving preprocessing against the JAX package's, and its serve
CLI end to end on the CPU (random weights from a seed, weights loaded from
a reference-layout checkpoint, the .obj dump and the --f32 alias)."""
import os

import numpy as np
import pytest
import torch

from gator_tpu.assets import COCO, H36M
from gator_tpu.data import processing as jax_processing
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import serve as serve_cli
from gator_tpu_torch.data import processing
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.serving import make_serving_fn
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)


def _poses(n, rng):
    poses = np.concatenate([rng.uniform(20, 600, size=(n, 17, 2)),
                            rng.uniform(0.2, 1.0, size=(n, 17, 1))], axis=2)
    return poses.astype(np.float32)


@pytest.mark.parametrize("joint_set", [H36M, COCO])
def test_preprocessing_matches_jax(joint_set):
    rng = np.random.default_rng(11)
    poses = _poses(9, rng)
    # a degenerate tight box (under a pixel wide): the fallback crop
    poses[0, :, 0] = 100.0 + rng.uniform(0, 0.5, size=17)
    if joint_set is COCO:
        names = list(COCO.joints_name)
        ours = processing.add_pelvis_neck_scores(poses, names)
        ref = jax_processing.add_pelvis_neck_scores(poses, names)
        np.testing.assert_array_equal(ours, ref)
        poses = ours
    n = len(poses)
    opts = jax_processing.ProcessOptions(is_train=False,
                                         input_joint_name=joint_set.name)
    ref = jax_processing.batch_crop_and_normalize(
        poses[..., :2], joint_set, opts, np.zeros(n, np.int64),
        np.zeros(n, np.float32))
    ours = processing.batch_crop_and_normalize(
        poses[..., :2], joint_set,
        processing.ProcessOptions(is_train=False,
                                  input_joint_name=joint_set.name),
        np.zeros(n, np.int64), np.zeros(n, np.float32))
    assert ours.dtype == np.float32
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def coco_assets():
    return build_assets("coco", data_dirs=[], synthetic_vertex_num=890,
                        seed=0)


def _served(tmp_path, coco_assets, poses, **kw):
    src = tmp_path / "poses.npy"
    np.save(src, poses)
    return serve_cli.run_serve(
        str(src), "coco", output=str(tmp_path / "meshes.npy"),
        joints_output=str(tmp_path / "joints.npy"), batch_size=4,
        dtype="float32", device="cpu", assets=coco_assets, **kw)


def _expected(model, coco_assets, poses):
    n = len(poses)
    pose2d = processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses, list(coco_assets.joint_set.joints_name))[..., :2],
        coco_assets.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name="coco"),
        np.zeros(n, np.int64), np.zeros(n, np.float32))
    mesh, pose3d = make_serving_fn(model, torch.float32)(
        torch.from_numpy(pose2d))
    return mesh.numpy(), pose3d.numpy()


def test_serve_cli_random_weights(tmp_path, coco_assets):
    poses = _poses(10, np.random.default_rng(2))
    out = _served(tmp_path, coco_assets, poses)
    assert out["meshes"].shape == (10, 890, 3)
    assert np.isfinite(out["meshes"]).all()
    np.testing.assert_array_equal(np.load(tmp_path / "meshes.npy"),
                                  out["meshes"])
    model = build_gator(GatorSpec.from_assets(coco_assets), seed=0,
                        device="cpu")
    mesh, pose3d = _expected(model, coco_assets, poses)
    np.testing.assert_allclose(out["meshes"], mesh, atol=1e-5)
    np.testing.assert_allclose(np.load(tmp_path / "joints.npy"), pose3d,
                               atol=1e-3)


def test_serve_cli_loads_reference_layout_weights(tmp_path, coco_assets):
    model = build_gator(GatorSpec.from_assets(coco_assets), seed=9,
                        device="cpu")
    ckpt = tmp_path / "ckpt.pth.tar"
    torch.save({"epoch": 1, "model_state_dict": {
        f"module.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    poses = _poses(6, np.random.default_rng(3))
    out = _served(tmp_path, coco_assets, poses, weights=str(ckpt))
    mesh, _ = _expected(model, coco_assets, poses)
    np.testing.assert_allclose(out["meshes"], mesh, atol=1e-5)


def test_serve_cli_obj_dump_and_f32_flag(tmp_path, coco_assets, monkeypatch):
    """`main` with --obj_dir / --obj_every / --f32 on the CPU: every
    --obj_every-th mesh as .obj, and --f32 serves exactly what
    --dtype float32 serves (the bf16 default does not)."""
    monkeypatch.setattr(serve_cli, "build_assets", lambda *a: coco_assets)
    poses = _poses(10, np.random.default_rng(4))
    src = tmp_path / "poses.npy"
    np.save(src, poses)
    objs = tmp_path / "objs"

    def serve(*flags):
        return serve_cli.main(["--input_poses", str(src), "--output",
                               str(tmp_path / "m.npy"), "--batch_size", "4",
                               "--device", "cpu", *flags])

    f32 = serve("--f32", "--obj_dir", str(objs), "--obj_every", "3")
    names = sorted(os.listdir(objs))
    assert names == [f"mesh_{i:06d}.obj" for i in (0, 3, 6, 9)]
    lines = (objs / "mesh_000006.obj").read_text().splitlines()
    verts = np.array([[float(x) for x in ln.split()[1:]]
                      for ln in lines if ln.startswith("v ")])
    assert verts.shape == (890, 3)
    np.testing.assert_allclose(verts, f32["meshes"][6], atol=1e-6)
    assert sum(ln.startswith("f ") for ln in lines) == len(coco_assets.faces)
    np.testing.assert_array_equal(
        f32["meshes"], serve("--dtype", "float32")["meshes"])
    assert not np.array_equal(f32["meshes"], serve()["meshes"])
    model = build_gator(GatorSpec.from_assets(coco_assets), seed=0,
                        device="cpu")
    mesh, _ = _expected(model, coco_assets, poses)
    np.testing.assert_allclose(f32["meshes"], mesh, atol=1e-5)
