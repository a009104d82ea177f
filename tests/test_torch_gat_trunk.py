"""K1, the GAT trunk: the port's plain version `gat_trunk_ref` against the
JAX package's fused kernel (interpret mode) and its XLA form, in f32 and
in bf16; and the kernel's launch geometry (`launch_plan`, `smem_bytes`),
which the CPU can check. The CUDA kernel is held against `gat_trunk_ref`
in test_torch_kernels_cuda.py.

Same weights on both sides (flax init -> `state_dict_from_jax` -> the
port's `GAT`). Bars: f32 atol 1e-4 (tests/test_serving.py:120); bf16 in
`test_gat_trunk_ref_bf16_matches_jax_kernel`.
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
from gator_tpu_torch.nn.gat_trunk import (JOINTS_MAX, SMEM_MAX, TILE_ROWS,
                                          launch_plan, panel_depth,
                                          panel_order, smem_bytes)
from gator_tpu_torch.nn import cuda_lib
from gator_tpu_torch.tools import profile_trunk, trunk_phases
from test_torch_lbf_layer import exact

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



def test_gat_trunk_ref_bf16_matches_jax_kernel(trunk_case):
    """The plain version in bf16 against the JAX kernel in bf16, so that
    the rounding points the CUDA kernel keeps (it is held to the plain
    version on the card) stay those of the TPU kernel. The JAX side runs
    in interpret mode with every bf16 cast kept (`exact`). The two differ
    where the TPU kernel folds V into the projection (`wvp`, rounded once)
    and keeps the attention in f32 until z, where the port rounds o and
    attn. Bars: max abs at most the spacing of bf16 values in the output's
    top binade, 2^(e - 7) for e = floor(log2 max|out|) (0.03125 here:
    two ulps of the binade below; measured 0.015625 at max|out| 4.25 and
    4.31), and at least half of the elements bit-equal (measured 0.68 and
    0.65)."""
    jspec, params, gat, x, bias = trunk_case
    bps = [extract_block_params(params, i, jspec.adjacency)
           for i in range(DEPTH)]
    want = exact(lambda xx, bb: gat_blocks_fused(
        xx, bb, bps, jspec.masks_xfeat, jspec.num_heads, group=2,
        interpret=True), jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(bias))
    want = np.asarray(want.astype(jnp.float32))
    weights = fold_trunk_weights(gat.blocks, torch.bfloat16, "cpu")
    got = gat_trunk_ref(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(bias),
                        torch.from_numpy(jspec.masks_xfeat), weights,
                        jspec.num_heads)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    bar = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert diff.max() <= bar, (diff.max(), bar)
    assert (diff == 0).mean() >= 0.5, (diff == 0).mean()


@pytest.mark.parametrize("c", [128, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gat_trunk_tile_fits_one_cta(dtype, c):
    """The kernel's shared memory (`Tile<T, C>::BYTES`, mirrored by
    `smem_bytes`) fits a CTA at both embed widths, and its tile holds
    whole samples of the largest skeleton it takes."""
    assert smem_bytes(dtype, c) <= SMEM_MAX
    assert TILE_ROWS[dtype] % 16 == 0 and TILE_ROWS[dtype] >= JOINTS_MAX


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gat_trunk_panels_hold_the_packed_matrices(trunk_case, dtype):
    """`pack_panels`: undoing the piece permutation of each panel and
    placing it at its (matrix, row, column) gives back every matrix of
    every block exactly, zero past the matrices' edges."""
    weights = fold_trunk_weights(trunk_case[2].blocks, dtype, "cpu")
    kp = panel_depth(dtype)
    order = panel_order(kp, 128)
    per = 8 if dtype == torch.bfloat16 else 4
    panels = weights.panels.view(len(weights.layers), len(order), kp,
                                 64 // per, per)
    for layer, blocks in zip(weights.layers, panels):
        rebuilt = {n: torch.zeros(layer[n].shape[0] + kp, layer[n].shape[1]
                                  + 64, dtype=dtype) for n, _, _ in order}
        for (name, r0, c0), blk in zip(order, blocks):
            k = torch.arange(kp)[:, None]
            swz = k & 7 if dtype == torch.bfloat16 else (k & 7) << 1
            logical = blk[k, torch.arange(64 // per)[None, :] ^ swz]
            rebuilt[name][r0:r0 + kp, c0:c0 + 64] = logical.reshape(kp, 64)
        for name, full in rebuilt.items():
            rows, cols = layer[name].shape
            assert torch.equal(full[:rows, :cols], layer[name]), name
            assert not full[rows:].any() and not full[:, cols:].any(), name
    assert len(order) == (68 if dtype == torch.bfloat16 else 134)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("j", [17, 19])
def test_gat_trunk_launch_plan_spreads_small_batches(dtype, j):
    """`launch_plan` on a 132-SM card: every sample has a CTA, no tile
    holds more rows than the kernel's, the fewest waves the tile allows
    and no CTA fewer than those waves need, and a batch of at most one
    sample per SM (B = 1, 64) takes one SM per sample."""
    sms, rows = 132, TILE_ROWS[dtype]
    for b in (1, 2, 63, 64, 131, 132, 133, 256, 300, 1001, 2048, 65537):
        plan = launch_plan(b, j, dtype, sms)
        g, ctas = plan["g"], plan["ctas"]
        assert g * j <= rows and plan["rows"] == g * j
        assert (ctas - 1) * g < b <= ctas * g
        fewest = -(-(-(-b // (rows // j))) // sms)
        assert plan["waves"] == fewest, (b, plan)
        assert (plan["waves"] - 1) * sms < ctas <= plan["waves"] * sms
        if b <= sms:
            assert ctas == b, (b, plan)
    assert launch_plan(256, 17, torch.bfloat16, sms)["ctas"] == 128
    assert launch_plan(2048, 17, torch.bfloat16, sms) == {
        "g": 4, "ctas": 512, "waves": 4, "rows": 68}


def test_gat_trunk_launch_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        launch_plan(0, 17, torch.bfloat16, 132)
    with pytest.raises(ValueError):
        launch_plan(4, JOINTS_MAX + 1, torch.bfloat16, 132)


def test_profile_trunk_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_trunk.main([])


def test_trunk_phases_stamps_every_phase_of_the_kernel():
    """tools/trunk_phases.py finds each of its stamp lines once in
    csrc/gat_trunk.cu (it fails at once when the kernel's text moves),
    and refuses to run without a card."""
    with open(f"{cuda_lib.CSRC}/gat_trunk.cu") as f:
        src = trunk_phases.stamped_source(f.read())
    for k in range(len(trunk_phases.PHASES) + 1):
        assert src.count(f"TS({k})") == 1, k
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        trunk_phases.main([])
