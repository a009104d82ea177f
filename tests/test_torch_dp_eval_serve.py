"""Sharded eval and serving over 3 gloo ranks on the CPU, against the JAX
package on a 3-device CPU mesh with the same converted weights:

- `run_eval(world=)` over a ragged 7-sample batch and a ragged 5-sample
  one: the exact per-sample means of the JAX `run_eval(mesh=)` (rtol
  1e-6), its count, and the collected predictions and targets in row
  order (predictions within 1e-4 m, the f32 serving bar of
  tests/test_reference_parity.py:7; targets exact); every rank gets the
  same result, equal to one process's `run_eval`;
- `make_sharded_serving_fn` on a ragged batch padded to a multiple of 3
  against `gator_tpu.serving.make_sharded_serving_fn`: the f32 mesh
  within 1e-4 m, the lifted joints within 1e-2 mm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.parallel import make_mesh, replicate
from gator_tpu.parallel import pad_to_multiple as jax_pad
from gator_tpu.serving import make_sharded_serving_fn as jax_sharded_fn
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import make_gator_eval_step as jax_gator_eval_step
from gator_tpu.train import make_optimizer
from gator_tpu.train import run_eval as jax_run_eval
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.parallel import pad_to_multiple, spawn
from gator_tpu_torch.parallel.checks import run_cases
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

V, RANKS = 890, 3
SPEC = {"embed_dim": 64, "depth": 2}


def _eval_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"pose2d": (0.5 + 0.25 * rng.standard_normal((n, 17, 2))).astype(
                np.float32),
            "mesh": rng.normal(size=(n, V, 3)).astype(np.float32) * 0.1,
            "reg_pose3d": rng.normal(size=(n, 17, 3)).astype(np.float32)
            * 100}


@pytest.fixture(scope="module")
def setup(small_assets):
    jspec = JaxGatorSpec.from_assets(small_assets, **SPEC, alpha=False)
    variables = jax_variables(init_gator, jspec, 5)
    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=V,
                           seed=0)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    batches = [_eval_batch(7, 1), _eval_batch(5, 2)]
    poses, real = pad_to_multiple(
        (0.5 + 0.25 * np.random.default_rng(3).standard_normal(
            (7, 17, 2))).astype(np.float32), RANKS)
    cases = [{"kind": "eval", "assets": passets, "spec": SPEC,
              "state_dict": sd, "batches": batches,
              "collect_out": ("pred_mesh_mm",), "collect_batch": ("mesh",)},
             {"kind": "serve", "assets": passets, "spec": SPEC,
              "state_dict": sd, "poses": poses}]
    ranks = spawn(run_cases, RANKS, args=(cases,), timeout=180)
    return {"jspec": jspec, "variables": variables, "cases": cases,
            "batches": batches, "poses": poses, "real": real,
            "ranks": ranks}


def test_sharded_run_eval_matches_jax_mesh_eval(small_assets, setup):
    mesh = make_mesh(jax.devices()[:RANKS])
    state = replicate(mesh, JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dict(setup["variables"])),
        make_optimizer("adam", 1e-3)))
    jstep = jax_gator_eval_step(setup["jspec"],
                                small_assets.j_regressor_h36m,
                                small_assets.joint_set.eval_joints)
    want = jax_run_eval(jstep, state, setup["batches"], mesh=mesh,
                        collect_out=("pred_mesh_mm",),
                        collect_batch=("mesh",))
    one = run_cases(None, setup["cases"][:1])[0]
    assert want["count"] == one["count"] == 12
    for got in [r[0] for r in setup["ranks"]]:
        assert got["count"] == 12
        for k in ("joint_err", "surface_err"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6,
                                       err_msg=k)
        assert got["pred_mesh_mm"].shape == got["mesh"].shape == (12, V, 3)
        np.testing.assert_array_equal(got["mesh"], want["mesh"])
        np.testing.assert_allclose(got["pred_mesh_mm"],
                                   want["pred_mesh_mm"], atol=0.1, rtol=0)
        np.testing.assert_allclose(got["pred_mesh_mm"],
                                   one["pred_mesh_mm"], atol=1e-3, rtol=0)


def test_sharded_serving_matches_jax_sharded_serving(setup):
    mesh = make_mesh(jax.devices()[:RANKS])
    fn = jax_sharded_fn(setup["jspec"], jax.tree_util.tree_map(
        jnp.asarray, dict(setup["variables"])), mesh=mesh,
        dtype=jnp.float32)
    padded, real = jax_pad({"x": setup["poses"][:setup["real"]]}, RANKS)
    np.testing.assert_array_equal(padded["x"], setup["poses"])
    jmesh, jpose = fn(jnp.asarray(padded["x"]))
    real = setup["real"]
    for got in [r[1] for r in setup["ranks"]]:
        assert got["mesh"].shape == (len(setup["poses"]), V, 3)
        np.testing.assert_allclose(got["mesh"][:real],
                                   np.asarray(jmesh)[:real], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got["pose3d"][:real],
                                   np.asarray(jpose)[:real], atol=1e-2,
                                   rtol=0)
