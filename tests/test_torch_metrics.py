"""The port's metrics on the CPU against the JAX package's on the same numpy
inputs (mm-scale joints and meshes): every error within 1e-4 mm. Procrustes
is also held to tests/golden/procrustes_aligned.npy (atol 1e-3, as
tests/test_golden.py:74) and, sample by sample, to the host form
`coords.rigid_align_np`; a mirrored target exercises the det(R) < 0 fix,
whatever signs the SVD gives its singular vectors.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu import metrics as jm
from gator_tpu_torch import metrics
from gator_tpu_torch.data.coords import rigid_align_np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)


def _pair(b, n, seed, noise=20.0):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 300, size=(b, n, 3)).astype(np.float32)
    pred = (gt + rng.normal(0, noise, size=(b, n, 3))).astype(np.float32)
    return pred, gt


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("eval_joints", [None, EVAL_JOINTS])
def test_joint_errors_match_jax(eval_joints):
    pred, gt = _pair(9, 17, 0)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    for per_sample in (False, True):
        _close(metrics.mpjpe(tp, tg, eval_joints, per_sample=per_sample),
               jm.mpjpe(jp, jg, eval_joints, per_sample=per_sample))
    _close(metrics.mpjpe(tp, tg, align=False),
           jm.mpjpe(jp, jg, align=False))
    _close(metrics.pa_mpjpe(tp, tg, eval_joints),
           jm.pa_mpjpe(jp, jg, eval_joints))


def test_mpvpe_matches_jax():
    mesh_p, mesh_g = _pair(5, 890, 1)
    root_p, root_g = _pair(5, 1, 2)
    args = [torch.from_numpy(a) for a in (mesh_p, mesh_g, root_p, root_g)]
    jargs = [jnp.asarray(a) for a in (mesh_p, mesh_g, root_p, root_g)]
    for per_sample in (False, True):
        _close(metrics.mpvpe(*args, per_sample=per_sample),
               jm.mpvpe(*jargs, per_sample=per_sample))


def test_compute_errors_and_accel_match_jax():
    pred, gt = _pair(6, 14, 3)
    got = metrics.compute_errors(torch.from_numpy(gt), torch.from_numpy(pred))
    want = jm.compute_errors(jnp.asarray(gt), jnp.asarray(pred))
    for g, w in zip(got, want):
        _close(g, w)
    seq_p, seq_g = _pair(12, 17, 4, noise=5.0)
    _close(metrics.accel_error(torch.from_numpy(seq_g),
                               torch.from_numpy(seq_p)),
           jm.accel_error(jnp.asarray(seq_g), jnp.asarray(seq_p)))


def test_procrustes_matches_jax_golden_and_host_form():
    pred, gt = _pair(8, 14, 5, noise=60.0)
    gt[0] = pred[0] * np.array([-1.0, 1.0, 1.0], np.float32)   # a mirror
    got = metrics.procrustes_align(torch.from_numpy(pred),
                                   torch.from_numpy(gt)).numpy()
    _close(got, jm.procrustes_align(jnp.asarray(pred), jnp.asarray(gt)),
           atol=1e-3)
    for i in range(len(pred)):
        _close(got[i], rigid_align_np(pred[i].astype(np.float64),
                                      gt[i].astype(np.float64)), atol=1e-3)
    # tests/test_golden.py:67-74
    gp = np.random.default_rng(3).standard_normal(
        (3, 14, 3)).astype(np.float32) * 80
    gg = np.random.default_rng(4).standard_normal(
        (3, 14, 3)).astype(np.float32) * 80
    _close(metrics.procrustes_align(torch.from_numpy(gp),
                                    torch.from_numpy(gg)),
           np.load(os.path.join(GOLDEN, "procrustes_aligned.npy")),
           atol=1e-3)
