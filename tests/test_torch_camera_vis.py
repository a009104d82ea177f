"""The port's camera layer (`models/camera.py`) and the rest of `vis.py`
against the JAX package's, on the same seeded inputs: the projection
within 1e-4 px, the closed-form fit within rtol 1e-4, a known camera
recovered, the Adam fit's learning-rate steps equal to optax's
schedule and the fit itself against optax's from one start (1e-3), the
crop-to-image camera within 1e-5; the software renderer and the 2D
keypoint drawing pixel-equal; the 3D pose plot written; an unknown
renderer refused."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gator_tpu import vis as jvis
from gator_tpu.models import camera as jcam
from gator_tpu_torch import vis
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import camera
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

CROP = 500.0


def _problem(seed, b=3):
    """Joints in metres, a camera, and its projection with pixel noise."""
    rng = np.random.default_rng(seed)
    pose3d = rng.normal(0, 0.4, (b, 17, 3)).astype(np.float32)
    s = rng.uniform(0.6, 1.2, (b, 1)).astype(np.float32)
    t = rng.normal(0, 0.1, (b, 2)).astype(np.float32)
    noise = rng.normal(0, 2.0, (b, 17, 2)).astype(np.float32)
    return pose3d, s, t, noise


def _jcam(s, t):
    return jcam.CamParams(s=jnp.asarray(s), t=jnp.asarray(t))


def _cam(s, t):
    return camera.CamParams(s=torch.from_numpy(s), t=torch.from_numpy(t))


def test_projection_matches_jax_and_formula():
    pose3d, s, t, _ = _problem(0)
    got = camera.project_weak_perspective(torch.from_numpy(pose3d),
                                          _cam(s, t), CROP)
    want = jcam.project_weak_perspective(jnp.asarray(pose3d), _jcam(s, t),
                                         CROP)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    by_hand = ((pose3d[..., :2] + t[:, None]) * s[:, None] * CROP / 2
               + CROP / 2)
    np.testing.assert_allclose(got, by_hand, rtol=1e-6, atol=1e-4)


def test_closed_form_recovers_a_known_camera_and_matches_jax():
    pose3d, s, t, noise = _problem(1)
    target = camera.project_weak_perspective(
        torch.from_numpy(pose3d), _cam(s, t), CROP)
    fit = camera.fit_camera_closed_form(torch.from_numpy(pose3d), target,
                                        CROP)
    np.testing.assert_allclose(fit.s, s, rtol=1e-4)
    np.testing.assert_allclose(fit.t, t, rtol=0, atol=1e-4)
    noisy = target + torch.from_numpy(noise)
    got = camera.fit_camera_closed_form(torch.from_numpy(pose3d), noisy,
                                        CROP)
    want = jcam.fit_camera_closed_form(jnp.asarray(pose3d),
                                       jnp.asarray(noisy.numpy()), CROP)
    np.testing.assert_allclose(got.s, np.asarray(want.s), rtol=1e-4)
    np.testing.assert_allclose(got.t, np.asarray(want.t), rtol=1e-4,
                               atol=1e-6)


def test_adam_learning_rates_are_optax_schedule():
    sched = optax.piecewise_constant_schedule(0.1, {500: 0.5, 1000: 0.02})
    for update in (0, 1, 499, 500, 501, 999, 1000, 1001, 1499):
        assert camera.adam_lr(update) == float(np.float32(sched(update)))


def test_adam_fit_matches_optax_from_one_start():
    """From the JAX package's own uniform draw; the L1 gradient is +1 at a
    zero residual in both. The bar is the last learning rate, 1e-3: an
    Adam step moves a parameter by about lr, and where the two f32 sums
    give a residual opposite signs the trajectories part by whole steps
    (0.01-0.02 apart after 400 steps at lr 0.1 on these problems, 1e-4 to
    2e-4 at the end); the L1 in pixels within 2e-3."""
    pose3d, s, t, noise = _problem(2, b=2)
    target = np.asarray(jcam.project_weak_perspective(
        jnp.asarray(pose3d), _jcam(s, t), CROP)) + noise
    want, want_loss = jcam.fit_camera_adam(jnp.asarray(pose3d),
                                           jnp.asarray(target), CROP)
    init = np.array(jax.random.uniform(jax.random.PRNGKey(0), (2, 3)))
    got, loss = camera.fit_camera_adam(
        torch.from_numpy(pose3d), torch.from_numpy(target), CROP,
        init=torch.from_numpy(init))
    np.testing.assert_allclose(got.s, np.asarray(want.s), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t, np.asarray(want.t), rtol=0, atol=1e-3)
    assert abs(float(loss) - float(want_loss)) <= 2e-3
    # its own start: a seeded torch.Generator draw, the same optimum
    seeded, _ = camera.fit_camera_adam(torch.from_numpy(pose3d),
                                       torch.from_numpy(target), CROP, seed=3)
    np.testing.assert_allclose(seeded.s, got.s, rtol=0, atol=1e-2)


def test_crop_cam_to_orig_img_matches_jax():
    _, s, t, _ = _problem(3)
    bbox = np.array([[40.0, 60.0, 300.0, 420.0], [10.0, 5.0, 80.0, 90.0],
                     [0.0, 0.0, 500.0, 500.0]], np.float32)
    got = camera.crop_cam_to_orig_img(_cam(s, t), torch.from_numpy(bbox),
                                      640, 480)
    want = jcam.crop_cam_to_orig_img(_jcam(s, t), jnp.asarray(bbox), 640,
                                     480)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    a = build_assets("coco", data_dirs=[], synthetic_vertex_num=890, seed=0)
    return a.mean_vertices.astype(np.float32), a.faces, a.joint_set


def test_software_render_pixel_equal(mesh):
    verts, faces, _ = mesh
    img = np.random.default_rng(4).integers(0, 255, (160, 200, 3),
                                            np.uint8)
    cam = np.array([0.9, 1.1, 0.05, -0.1], np.float32)
    got = vis.render_mesh_overlay(img, verts, faces, cam,
                                  backend="software")
    want = jvis.render_mesh_overlay(img, verts, faces, cam,
                                    backend="software")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert (got != img).any(axis=-1).sum() > 100
    np.testing.assert_array_equal(got, want)


def test_unknown_backend_raises(mesh):
    verts, faces, _ = mesh
    with pytest.raises(ValueError, match="unknown backend"):
        vis.render_mesh_overlay(np.zeros((8, 8, 3), np.uint8), verts, faces,
                                np.ones(4), backend="opengl")


def test_vis_2d_keypoints_equal(mesh):
    _, _, joint_set = mesh
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (240, 320, 3), np.uint8)
    kps = np.stack([rng.uniform(0, 320, 19), rng.uniform(0, 240, 19),
                    rng.uniform(0, 1, 19)]).astype(np.float32)
    for alpha in (1.0, 0.6):
        got = vis.vis_2d_keypoints(img, kps, joint_set.skeleton,
                                   alpha=alpha)
        want = jvis.vis_2d_keypoints(img, kps, joint_set.skeleton,
                                     alpha=alpha)
        assert (got != img).any()
        np.testing.assert_array_equal(got, want)


def test_vis_3d_pose_writes_a_png(tmp_path, mesh):
    _, _, joint_set = mesh
    joints = np.random.default_rng(6).normal(size=(19, 3))
    path = tmp_path / "pose3d.png"
    vis.vis_3d_pose(joints, joint_set.skeleton, str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
