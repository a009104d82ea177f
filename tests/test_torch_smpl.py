"""The port's body model and GT synthesis on the CPU against the JAX
package: rotations, the batched SMPL layer (and the goldens of
tests/test_golden.py), and the `gt_synth` functions of the eval path, on
the same numpy inputs and the same synthetic SMPL model. Bars: rotations
within 1e-5, meshes within 1e-5 m (1e-2 mm in millimetres), the goldens at
tests/test_golden.py's 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.bodymodel import SmplParams as JaxSmplParams
from gator_tpu.bodymodel import rotations as jrot
from gator_tpu.bodymodel import smpl_forward as jax_smpl_forward
from gator_tpu.data import GtSynthesizer as JaxGtSynthesizer
from gator_tpu.data import gt_synth as jgt
from gator_tpu_torch.assets import build_assets, synthetic_smpl
from gator_tpu_torch.bodymodel import (SmplParams, axis_angle_to_rotmat,
                                       rotmat_flat_minus_id,
                                       rotmat_to_axis_angle, rotmat_to_quat,
                                       smpl_forward, substitute_mean_betas)
from gator_tpu_torch.data import GtSynthesizer
from gator_tpu_torch.data import gt_synth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _rotations(rng, n=64):
    """Axis-angles of random angles, zero, and angles at and near pi (where
    the trace-only quaternion branch loses all precision)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, np.pi, n - 8),
                          [0.0, 1e-4, np.pi, np.pi - 1e-3, 3.0, 3.1, 2.9,
                           np.pi - 1e-5]])
    return (v * ang[:, None]).astype(np.float32)


def test_rotations_match_jax():
    aa = _rotations(np.random.default_rng(0))
    rot_j = np.asarray(jrot.axis_angle_to_rotmat(jnp.asarray(aa)))
    rot = axis_angle_to_rotmat(torch.from_numpy(aa))
    np.testing.assert_allclose(rot.numpy(), rot_j, atol=1e-6)
    np.testing.assert_allclose(
        rotmat_to_quat(rot).numpy(),
        np.asarray(jrot.rotmat_to_quat(jnp.asarray(rot_j))), atol=1e-5)
    back = rotmat_to_axis_angle(rot).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jrot.rotmat_to_axis_angle(jnp.asarray(rot_j))),
        atol=1e-5)
    # the round trip recovers the rotation (angles in [0, pi])
    np.testing.assert_allclose(
        axis_angle_to_rotmat(torch.from_numpy(back)).numpy(), rot_j,
        atol=1e-5)
    np.testing.assert_array_equal(
        rotmat_flat_minus_id(torch.from_numpy(rot_j.reshape(8, 8, 3, 3)))
        .numpy(),
        np.asarray(jrot.rotmat_flat_minus_id(
            jnp.asarray(rot_j.reshape(8, 8, 3, 3)))))


@pytest.mark.parametrize("with_trans", [False, True])
def test_smpl_forward_matches_jax(with_trans):
    model = synthetic_smpl(vertex_num=890, seed=2)
    rng = np.random.default_rng(5)
    pose = (0.4 * rng.standard_normal((6, 72))).astype(np.float32)
    pose[0] = 0.0
    betas = rng.standard_normal((6, 10)).astype(np.float32)
    trans = rng.normal(size=(6, 3)).astype(np.float32) if with_trans \
        else None
    vj, jj = jax_smpl_forward(
        JaxSmplParams.from_model(model), jnp.asarray(pose),
        jnp.asarray(betas), None if trans is None else jnp.asarray(trans))
    v, j = smpl_forward(
        SmplParams.from_model(model, device="cpu"), torch.from_numpy(pose),
        torch.from_numpy(betas),
        None if trans is None else torch.from_numpy(trans))
    assert v.shape == (6, 890, 3) and j.shape == (6, 24, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), atol=1e-5)


def test_smpl_forward_goldens():
    """tests/golden/smpl_{verts,joints}_500.npy, built as
    tests/test_golden.py:29-42 builds them."""
    model = synthetic_smpl(vertex_num=500, seed=3)
    pose = (0.3 * np.random.default_rng(7).standard_normal(
        (2, 72))).astype(np.float32)
    betas = np.random.default_rng(8).standard_normal(
        (2, 10)).astype(np.float32)
    v, j = smpl_forward(SmplParams.from_model(model, device="cpu"),
                        torch.from_numpy(pose), torch.from_numpy(betas))
    np.testing.assert_allclose(
        v.numpy()[:, ::50], np.load(os.path.join(GOLDEN,
                                                 "smpl_verts_500.npy")),
        atol=1e-5)
    np.testing.assert_allclose(
        j.numpy(), np.load(os.path.join(GOLDEN, "smpl_joints_500.npy")),
        atol=1e-5)


def test_substitute_mean_betas():
    betas = np.array([[0.0] * 10, [1.0] + [0.0] * 9], np.float32)
    mean = np.arange(10, dtype=np.float32)
    out = substitute_mean_betas(betas, mean)
    np.testing.assert_array_equal(out[0], mean)
    np.testing.assert_array_equal(out[1], betas[1])


def _gt_inputs(n, rng):
    pose = (0.25 * rng.standard_normal((n, 72))).astype(np.float32)
    pose[:, :3] = rng.normal(size=(n, 3)) * 1.5   # roots up to ~pi
    shape = rng.uniform(-1.5, 1.5, (n, 10)).astype(np.float32)
    shape[0] = 0.0                                # mean-beta substitution
    shape[1, 3] = 4.0                             # a fit failure, cleaned
    trans = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    yaw = rng.uniform(-3.0, 3.0, n)
    cam_r = np.zeros((n, 3, 3), np.float32)
    cam_r[:, 0, 0], cam_r[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    cam_r[:, 1, 1] = 1
    cam_r[:, 2, 0], cam_r[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    cam_t = np.stack([rng.normal(0, 100, n), rng.normal(0, 100, n),
                      rng.uniform(4000, 6000, n)], 1).astype(np.float32)
    focal = np.full((n, 2), 1500.0, np.float32)
    princpt = np.full((n, 2), 500.0, np.float32)
    return pose, shape, trans, cam_r, cam_t, focal, princpt


@pytest.mark.parametrize("joint_set", ["human36", "coco"])
def test_gt_synthesis_matches_jax(joint_set, small_assets,
                                  small_assets_coco):
    jassets = {"human36": small_assets, "coco": small_assets_coco}[joint_set]
    passets = build_assets(joint_set, data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    rng = np.random.default_rng(11)
    args = _gt_inputs(7, rng)
    gt_h36m = rng.normal(0, 200, size=(7, 17, 3)).astype(np.float32)
    jsyn = JaxGtSynthesizer(jassets)
    syn = GtSynthesizer(passets, device="cpu")
    want = jsyn.synthesize(*args, joint_cam_h36m=gt_h36m)
    got = syn.synthesize(*args, joint_cam_h36m=gt_h36m)
    assert set(got) == set(want)
    for key in ("smpl_joints_mm", "joint_cam_coco", "mesh_mm"):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=1e-2,
                                   err_msg=key)      # mm: 1e-5 m
    np.testing.assert_allclose(got["joint_img_coco"], want["joint_img_coco"],
                               atol=1e-3)            # pixels
    np.testing.assert_allclose(got["fitting_error"], want["fitting_error"],
                               atol=1e-2)
    mesh_mm = got["mesh_mm"]
    root = gt_h36m[:, :1]
    np.testing.assert_allclose(
        syn.mesh_rel_m(mesh_mm, root).numpy(),
        np.asarray(jsyn.mesh_rel_m(want["mesh_mm"], root)), atol=1e-5)
    np.testing.assert_allclose(
        syn.h36m_from_mesh(mesh_mm).numpy(),
        np.asarray(jsyn.h36m_from_mesh(want["mesh_mm"])), atol=1e-2)
    thr = float(np.median(got["fitting_error"]))
    np.testing.assert_array_equal(
        syn.fit_valid_mask(torch.from_numpy(got["fitting_error"]),
                           thr).numpy(),
        np.asarray(jgt.fit_valid_mask_fn(jnp.asarray(got["fitting_error"]),
                                         thr)))
    s = rng.uniform(120, 180, (7, 1)).astype(np.float32)
    t = rng.uniform(200, 400, (7, 2)).astype(np.float32)
    for got_a, want_a in zip(
            gt_synth.coco_weak_perspective_fn(syn.j_reg_coco, mesh_mm,
                                              torch.from_numpy(s),
                                              torch.from_numpy(t)),
            jgt.coco_weak_perspective_fn(jsyn.j_reg_coco, want["mesh_mm"],
                                         jnp.asarray(s), jnp.asarray(t))):
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                                   atol=1e-2)
