"""K1, the GAT trunk: the port's plain version `gat_trunk_ref` against the
JAX package's fused kernel (interpret mode) and its XLA form. The CUDA
kernel is held against `gat_trunk_ref` in test_torch_kernels_cuda.py.

Same weights on both sides (flax init -> `state_dict_from_jax` -> the
port's `GAT`). Bar: f32 atol 1e-4 (tests/test_serving.py:120).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.models import GatSpec as JaxGatSpec
from gator_tpu.models.gator import init_gat
from gator_tpu.nn.pallas_gat import (extract_block_params, gat_blocks_fused,
                                     gat_blocks_xla)
from test_torch_convert import jax_variables
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GAT, GatSpec
from gator_tpu_torch.nn import fold_trunk_weights, gat_trunk, gat_trunk_ref

DEPTH = 2


def _setup(joint_set, jax_assets, seed=0):
    jspec = JaxGatSpec.from_assets(jax_assets, embed_dim=128, depth=DEPTH)
    params = jax_variables(init_gat, jspec, seed)
    passets = port_assets.build_assets(joint_set, data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    gat = GAT(GatSpec.from_assets(passets, embed_dim=128, depth=DEPTH))
    gat.load_state_dict(state_dict_from_jax(params), strict=True)
    rng = np.random.default_rng(seed + 3)
    j = jspec.num_joint
    x = rng.normal(size=(4, j, 128)).astype(np.float32)
    bias = rng.normal(size=(jspec.num_heads, j, j)).astype(np.float32)
    return jspec, params["params"], gat, x, bias


@pytest.fixture(scope="module", params=["human36", "coco"])
def trunk_case(request, small_assets, small_assets_coco):
    jax_assets = {"human36": small_assets, "coco": small_assets_coco}
    return _setup(request.param, jax_assets[request.param])


def test_gat_trunk_ref_matches_jax(trunk_case):
    jspec, params, gat, x, bias = trunk_case
    bps = [extract_block_params(params, i, jspec.adjacency)
           for i in range(DEPTH)]
    fused = gat_blocks_fused(jnp.asarray(x), jnp.asarray(bias), bps,
                             jspec.masks_xfeat, jspec.num_heads, group=2,
                             interpret=True)
    xla = gat_blocks_xla(jnp.asarray(x), jnp.asarray(bias), bps,
                         jspec.masks_xfeat, jspec.num_heads)
    weights = fold_trunk_weights(gat.blocks, torch.float32, "cpu")
    masks = torch.from_numpy(jspec.masks_xfeat)
    got = gat_trunk_ref(torch.from_numpy(x), torch.from_numpy(bias), masks,
                        weights, jspec.num_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-4)
    # the public entry point takes the plain version for a CPU tensor
    disp = gat_trunk(torch.from_numpy(x), torch.from_numpy(bias), masks,
                     weights, jspec.num_heads)
    assert torch.equal(disp, got)

