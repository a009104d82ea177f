"""The GAT kernels K1 and K5 at embed width 64 (8 heads), the width of the
JAX package's multichip dry run (`__graft_entry__.py:94`), on the CPU: the
port's plain versions against the JAX kernels in interpret mode at embed
64, 8 heads, J=17, depth 2, f32 (forward within 1e-5; K5's gradients,
each scaled by its max, within 1e-5); the converted width-64 weights
against the JAX serving mesh (1e-4 m, tests/test_serving.py); and the
width check that every CUDA build calls (`nn.gat_trunk.check_width`),
while a CPU build takes any width. The CUDA kernels are held to the plain
versions at C=64 in test_torch_kernels_cuda.py and
test_torch_train_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import GatSpec as JaxGatSpec
from gator_tpu.models.gator import init_gat, init_gator
from gator_tpu.nn import pallas_gat_train as pgt
from gator_tpu.nn.pallas_gat import (extract_block_params, gat_blocks_fused,
                                     gat_blocks_xla)
from gator_tpu.serving import make_serving_fn as jax_make_serving_fn
from test_torch_convert import jax_variables
from test_torch_gat_trunk_train import _torch_vjp
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import (GAT, GATOR, GatorSpec, GatSpec, build_gat,
                                    build_gator)
from gator_tpu_torch.nn import fold_trunk_weights, gat_trunk
from gator_tpu_torch.nn.gat_trunk import WIDTHS, check_width
from gator_tpu_torch.nn.gat_trunk_train import (BLOCK_PARAM_KEYS,
                                                gat_trunk_train)
from gator_tpu_torch.serving import make_serving_fn

C, H, J, DEPTH = 64, 8, 17, 2


@pytest.fixture(scope="module")
def gat64(small_assets):
    """(JAX spec, JAX params, the port's GAT) at embed 64 with the same
    weights, and seeded inputs."""
    jspec = JaxGatSpec.from_assets(small_assets, embed_dim=C, depth=DEPTH)
    params = jax_variables(init_gat, jspec, 5)
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    gat = GAT(GatSpec.from_assets(passets, embed_dim=C, depth=DEPTH))
    gat.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, J, C)).astype(np.float32)
    bias = rng.normal(size=(H, J, J)).astype(np.float32)
    return jspec, params["params"], gat, x, bias


def test_gat_trunk_ref_at_embed_64_matches_jax_kernel(gat64):
    jspec, params, gat, x, bias = gat64
    assert jspec.num_heads == H and jspec.num_joint == J
    bps = [extract_block_params(params, i, jspec.adjacency)
           for i in range(DEPTH)]
    fused = gat_blocks_fused(jnp.asarray(x), jnp.asarray(bias), bps,
                             jspec.masks_xfeat, H, group=2, interpret=True)
    xla = gat_blocks_xla(jnp.asarray(x), jnp.asarray(bias), bps,
                         jspec.masks_xfeat, H)
    weights = fold_trunk_weights(gat.blocks, torch.float32, "cpu")
    got = gat_trunk(torch.from_numpy(x), torch.from_numpy(bias),
                    torch.from_numpy(jspec.masks_xfeat), weights, H)
    assert got.shape == (4, J, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-5)


def _jax_block_params(params, jspec):
    """The JAX package's per-block training parameters as numpy, in the
    port's key order."""
    return [{k: np.asarray(v) for k, v in
             extract_block_params(params, i, jspec.adjacency).items()}
            for i in range(DEPTH)]


def test_gat_trunk_train_at_embed_64_matches_jax_kernel(gat64):
    """K5's plain version (the wrapper on CPU tensors) at rate 0 against
    the JAX training trunk in interpret mode: output and every cotangent
    (dx, the hop/path bias, each block's 25 parameters)."""
    jspec, params, _, x, bias = gat64
    bps = _jax_block_params(params, jspec)
    xm = np.asarray(jspec.masks_xfeat, np.float32)
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    zero = dict(attn_rate=0.0, proj_rate=0.0, mlp_rate=0.0,
                drop_path_rate=0.0)
    n = len(BLOCK_PARAM_KEYS)
    flat = [bp[k] for bp in bps for k in BLOCK_PARAM_KEYS]

    def unflat(plist):
        return [dict(zip(BLOCK_PARAM_KEYS, plist[i * n:(i + 1) * n]))
                for i in range(DEPTH)]

    def port(x, bias, *plist):
        return gat_trunk_train(x, bias, unflat(plist), xm, H, 5, **zero)

    out, got = _torch_vjp(port, [x, bias] + flat, cot)

    def jax_trunk(x, bias, *plist):
        return pgt.gat_trunk_train(x, bias, unflat(plist), xm, H,
                                   jnp.asarray([5], jnp.int32),
                                   interpret=True, **zero)

    want_out, vjp = jax.vjp(jax_trunk, *[jnp.asarray(a)
                                         for a in [x, bias] + flat])
    np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
    names = ("dx", "dbias") + BLOCK_PARAM_KEYS * DEPTH
    for name, a, b in zip(names, got, vjp(jnp.asarray(cot))):
        a, b = np.asarray(a), np.asarray(b)
        if name == "qkv_b":
            # the key-bias slice has a zero true gradient (softmax is
            # invariant to a shift of the keys): rounding noise both sides
            assert np.abs(a[C:2 * C]).max() < 1e-5, name
            keep = np.ones(a.shape, bool)
            keep[C:2 * C] = False
            a, b = a[keep], b[keep]
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5,
                                   err_msg=f"cotangent {name}")


def test_converted_weights_at_embed_64_give_the_jax_mesh(small_assets):
    """`state_dict_from_jax` on a width-64 JAX GATOR: the port's serving
    path (the plain versions on the CPU) gives the JAX serving mesh."""
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=C, depth=DEPTH)
    variables = jax_variables(init_gator, jspec, 3)
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=C, depth=DEPTH))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    pose = np.random.default_rng(7).normal(size=(4, J, 2)).astype(
        np.float32)
    mesh, pose3d = make_serving_fn(model.eval(), dtype=torch.float32)(
        torch.from_numpy(pose))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jmesh, jpose = jax.jit(jax_make_serving_fn(jspec, jvars,
                                               dtype=jnp.float32))(
        jnp.asarray(pose))
    assert mesh.shape == (4, model.spec.mdr.full_num, 3)
    np.testing.assert_allclose(mesh.numpy(), np.asarray(jmesh), atol=1e-4)
    np.testing.assert_allclose(pose3d.numpy(), np.asarray(jpose), atol=1e-4)


@pytest.mark.parametrize("pair,ok", [((64, 8), True), ((128, 8), True),
                                     ((96, 8), False), ((128, 4), False)])
def test_check_width_takes_the_kernels_pairs_only(pair, ok):
    if ok:
        check_width(*pair)
        return
    with pytest.raises(ValueError) as err:
        check_width(*pair)
    for embed, heads in WIDTHS:
        assert f"({embed}, {heads})" in str(err.value)


def test_cuda_builds_refuse_other_widths_and_cpu_builds_run(small_assets):
    """A CUDA build at (96, 8) raises before it touches the card (this
    machine may have none); a CPU build at (96, 8) serves, on the plain
    versions."""
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    spec = GatorSpec.from_assets(passets, embed_dim=96, depth=DEPTH)
    assert spec.gat.num_heads == 8
    with pytest.raises(ValueError, match="embed_dim, num_heads"):
        build_gator(spec, device="cuda")
    with pytest.raises(ValueError, match="embed_dim, num_heads"):
        build_gat(spec.gat, device="cuda")
    model = build_gator(spec, seed=1, device="cpu")
    pose = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, J, 2)).astype(np.float32))
    mesh, _ = make_serving_fn(model, dtype=torch.float32)(pose)
    assert mesh.shape == (3, model.spec.mdr.full_num, 3)
    assert torch.isfinite(mesh).all()
