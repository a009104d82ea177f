"""The PyTorch port's serving path and module-form GATOR against the JAX
package on the CPU (the port's kernels run their plain versions here).

Same weights on both sides: flax init -> `state_dict_from_jax` ->
`GATOR.load_state_dict(strict=True)`, with the BatchNorm running stats
randomised first. Bars: mesh and pose3d within 1e-4 in f32
(tests/test_serving.py); the bf16 port within 5e-2 m of JAX f32.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.models import GATOR as JaxGATOR
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.serving import make_serving_fn as jax_make_serving_fn
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.serving import make_serving_fn
from test_torch_convert import jax_variables

CASES = {"human36": (17, False, 1), "coco": (19, True, 2)}


def _pair(joint_set, jax_assets):
    """(JAX spec, JAX variables, port GATOR) with the same weights."""
    j, alpha, seed = CASES[joint_set]
    jspec = JaxGatorSpec.from_assets(jax_assets, embed_dim=128, depth=2,
                                     alpha=alpha)
    variables = jax_variables(init_gator, jspec, seed)
    if not alpha:
        rng = np.random.default_rng(seed)
        bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    passets = port_assets.build_assets(joint_set, data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=128, depth=2,
                                        alpha=alpha))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jspec, variables, model.eval()


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, small_assets, small_assets_coco):
    jax_assets = {"human36": small_assets, "coco": small_assets_coco}
    jspec, variables, model = _pair(request.param, jax_assets[request.param])
    j = CASES[request.param][0]
    pose = np.random.default_rng(7).normal(size=(4, j, 2)).astype(np.float32)
    ref_mesh, ref_pose = jax.jit(lambda v, x: JaxGATOR(spec=jspec).apply(
        v, x, deterministic=True))(variables, jnp.asarray(pose))
    return {"jspec": jspec, "variables": variables, "model": model,
            "pose": pose, "ref_mesh": np.asarray(ref_mesh),
            "ref_pose": np.asarray(ref_pose)}


def test_port_serving_matches_jax_serving_and_module(pair):
    fn = make_serving_fn(pair["model"], dtype=torch.float32)
    mesh, pose3d = fn(torch.from_numpy(pair["pose"]))
    jvars = jax.tree_util.tree_map(jnp.asarray, pair["variables"])
    jfn = jax.jit(jax_make_serving_fn(pair["jspec"], jvars,
                                      dtype=jnp.float32))
    jmesh, jpose = jfn(jnp.asarray(pair["pose"]))
    assert mesh.shape == pair["ref_mesh"].shape
    np.testing.assert_allclose(mesh.numpy(), np.asarray(jmesh), atol=1e-4)
    np.testing.assert_allclose(pose3d.numpy(), np.asarray(jpose), atol=1e-4)
    np.testing.assert_allclose(mesh.numpy(), pair["ref_mesh"], atol=1e-4)
    np.testing.assert_allclose(pose3d.numpy(), pair["ref_pose"], atol=1e-4)


def test_port_module_matches_jax_module(pair):
    with torch.no_grad():
        mesh, pose3d = pair["model"](torch.from_numpy(pair["pose"]))
    np.testing.assert_allclose(mesh.numpy(), pair["ref_mesh"], atol=1e-4)
    np.testing.assert_allclose(pose3d.numpy(), pair["ref_pose"], atol=1e-4)


def test_port_serving_bf16_close_to_jax_f32(pair):
    fn = make_serving_fn(pair["model"], dtype=torch.bfloat16)
    mesh, pose3d = fn(torch.from_numpy(pair["pose"]))
    assert mesh.dtype == torch.bfloat16
    err = np.abs(mesh.float().numpy() - pair["ref_mesh"])
    assert np.isfinite(err).all() and err.max() < 5e-2


def test_port_serving_matches_goldens(small_assets):
    """The JAX package's golden forward (tests/test_golden.py:45), run on
    the port's serving path with the converted weights."""
    golden = os.path.join(os.path.dirname(__file__), "golden")
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=128, depth=2)
    variables = jax_variables(init_gator, jspec, 12)
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=128, depth=2))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    pose = np.random.default_rng(5).standard_normal(
        (2, 17, 2)).astype(np.float32)
    mesh, pose3d = make_serving_fn(model.eval(), dtype=torch.float32)(
        torch.from_numpy(pose))
    np.testing.assert_allclose(
        mesh.numpy()[:, ::100],
        np.load(os.path.join(golden, "gator_mesh_rows.npy")), atol=5e-4)
    np.testing.assert_allclose(
        pose3d.numpy(), np.load(os.path.join(golden, "gator_pose3d.npy")),
        atol=5e-4)
