"""The port's train steps, optimizer, losses and schedules against the JAX
package on the CPU (the kernels run their plain versions here).

Same weights on both sides (flax init -> `state_dict_from_jax`), every
dropout rate 0 on both sides, f32. Bars: loss terms rtol 1e-5; every
parameter gradient, converted to the port's names by the weight
converter, scaled by its max within 5e-4 (tests/test_fused_step.py:245);
BatchNorm running stats atol 1e-5. The attention key biases have a zero
true gradient and are held to an absolute bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gator_tpu import losses as jlosses
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import GatSpec as JaxGatSpec
from gator_tpu.models import init_gat, init_gator
from gator_tpu.nn.pallas_gat_train import gat_trunk_train as jax_trunk
from gator_tpu.nn.pallas_mdr_train import ZERO_RATES as JAX_ZERO
from gator_tpu.serving import gat_serving_forward
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import schedule as jschedule
from gator_tpu.train.loop import make_gator_train_step as jax_gator_step
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch import losses
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GATOR, GatorSpec, GatSpec
from gator_tpu_torch.models.gat import GAT
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
from gator_tpu_torch.train import (Adam, ReduceLROnPlateau, TrainState,
                                   make_gat_train_step, make_gator_train_step,
                                   multistep_lr)
from test_torch_convert import jax_variables

B, V = 4, 890
ZERO_GAT = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)


def _capture_grads():
    """An optax transformation whose state after `update` is the gradient
    tree (and whose updates are zero), so a JAX step hands its grads out."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _assert_grads(port_grads, jax_grads, bar=5e-4):
    """Every parameter's gradient, by the converter's names."""
    assert set(port_grads) == set(jax_grads)
    for name, want in jax_grads.items():
        got = port_grads[name].numpy()
        want = want.numpy()
        if name.endswith("attn.qkv.bias"):
            c = got.shape[0] // 3
            assert np.abs(got[c:2 * c]).max() < 1e-5, name
            keep = np.ones(got.shape, bool)
            keep[c:2 * c] = False
            got, want = got[keep], want[keep]
        elif name.endswith("linears.1.bias") and "selfatt" in name:
            assert np.abs(got).max() < 1e-5, name
            continue
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, atol=bar,
                                   err_msg=f"grad {name}")


def _batch(j, seed):
    rng = np.random.default_rng(seed)
    return {
        "pose2d": (0.5 + 0.25 * rng.standard_normal((B, j, 2))).astype(
            np.float32),
        "mesh": rng.normal(size=(B, V, 3)).astype(np.float32) * 0.1,
        "lift_pose3d": rng.normal(size=(B, j, 3)).astype(np.float32) * 100,
        "reg_pose3d": rng.normal(size=(B, 17, 3)).astype(np.float32) * 100,
        "mesh_valid": (rng.uniform(size=(B, 1, 1)) < 0.8).astype(np.float32),
        "lift_valid": np.ones((B, j, 1), np.float32),
        "reg_valid": np.ones((B, 17, 1), np.float32),
    }


@pytest.mark.parametrize("joint_set,alpha", [("human36", False),
                                             ("coco", True)])
def test_stage2_step_matches_jax_fused_step(small_assets, small_assets_coco,
                                            joint_set, alpha):
    jassets = {"human36": small_assets, "coco": small_assets_coco}[joint_set]
    jspec = JaxGatorSpec.from_assets(jassets, embed_dim=64, depth=2,
                                     alpha=alpha, **ZERO_GAT)
    variables = jax_variables(init_gator, jspec, 0)
    if not alpha:
        rng = np.random.default_rng(3)
        bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)
    j = jassets.joint_num
    batch = _batch(j, 5)

    tx = _capture_grads()
    step = jax_gator_step(jspec, jassets.faces, jassets.j_regressor_h36m,
                          jlosses.LossWeights(), tx, dtype=jnp.float32,
                          fused=True, fused_interpret=True,
                          fused_opts=dict(rates=JAX_ZERO, gat_mlp_rate=0.0))
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)), tx)
    jstate2, jm = jax.jit(step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jnp.asarray(1.0))

    passets = port_assets.build_assets(joint_set, data_dirs=[],
                                       synthetic_vertex_num=V, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=64, depth=2,
                                        alpha=alpha, **ZERO_GAT))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = TrainState(model, Adam(model.parameters(), lr=0.0))
    pstep = make_gator_train_step(model.spec, passets.faces,
                                  passets.j_regressor_h36m,
                                  losses.LossWeights(), use_kernels=True,
                                  rates=ZERO_RATES, gat_mlp_rate=0.0)
    pm = pstep(state, {k: torch.from_numpy(v) for k, v in batch.items()},
               seed=0, edge_enabled=1.0)

    for key in ("loss", "vertex", "normal", "edge", "reg_joint",
                "lift_joint"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    jgrads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jstate2.opt_state)})
    _assert_grads({n: p.grad for n, p in model.named_parameters()}, jgrads)
    assert state.step == 1
    if not alpha:
        bn = jstate2.batch_stats["pose2mesh"]["bias_norm"]
        np.testing.assert_allclose(
            model.pose2mesh.bias_norm.running_mean.numpy(),
            np.asarray(bn["mean"]), atol=1e-5)
        np.testing.assert_allclose(
            model.pose2mesh.bias_norm.running_var.numpy(),
            np.asarray(bn["var"]), atol=1e-5)


def test_stage1_step_matches_jax_reference(small_assets):
    """Stage 1 against a JAX reference built from its parts
    (tests/test_fused_step.py:193-230): gat_serving_forward with the
    training trunk at all rates 0, then coord_l1_loss."""
    jspec = JaxGatSpec.from_assets(small_assets, embed_dim=64, depth=2,
                                   **ZERO_GAT)
    variables = jax_variables(init_gat, jspec, 2)
    rng = np.random.default_rng(8)
    pose2d = (0.5 + 0.25 * rng.standard_normal((B, 17, 2))).astype(
        np.float32)
    joint_cam = rng.normal(0, 100, (B, 17, 3)).astype(np.float32)
    valid = (rng.uniform(size=(B, 17, 1)) < 0.9).astype(np.float32)
    seed = jnp.asarray([5], jnp.int32)

    def trunk(x, bias, block_params):
        return jax_trunk(x, bias, block_params, jspec.masks_xfeat,
                         jspec.num_heads, seed, attn_rate=0.0, proj_rate=0.0,
                         mlp_rate=0.0, drop_path_rate=0.0, interpret=True)

    def loss_fn(params):
        p3, _ = gat_serving_forward(jspec, params, jnp.asarray(pose2d),
                                    dtype=jnp.float32, trunk=trunk)
        return jlosses.coord_l1_loss(p3.reshape(-1, 17, 3),
                                     jnp.asarray(joint_cam),
                                     jnp.asarray(valid))

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)

    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=V, seed=0)
    model = GAT(GatSpec.from_assets(passets, embed_dim=64, depth=2,
                                    **ZERO_GAT))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = TrainState(model, Adam(model.parameters(), lr=0.0))
    step = make_gat_train_step(model.spec, mlp_rate=0.0)
    out = step(state, {"pose2d": torch.from_numpy(pose2d),
                       "joint_cam": torch.from_numpy(joint_cam),
                       "joint_valid": torch.from_numpy(valid)}, seed=5)
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-5)
    _assert_grads({n: p.grad for n, p in model.named_parameters()},
                  state_dict_from_jax({"params": jax.tree_util.tree_map(
                      np.asarray, jgrads)}))


def test_adam_matches_optax_for_two_steps(small_assets):
    """The same (converted JAX) gradients into the port's Adam and into
    optax.adam: parameters agree within 1e-7 (or one ulp of the parameter:
    XLA's CPU sqrt is not correctly rounded, so p + u may round one ulp
    apart)."""
    jspec = JaxGatSpec.from_assets(small_assets, embed_dim=64, depth=2)
    variables = jax_variables(init_gat, jspec, 6)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 1e-2, p.shape), jnp.float32)
        * (rng.uniform() < 0.9), params) for _ in range(2)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)

    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=V, seed=0)
    model = GAT(GatSpec.from_assets(passets, embed_dim=64, depth=2))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    named = dict(model.named_parameters())
    opt = Adam(model.parameters(), lr=1e-3)
    for g in grads:
        for name, val in state_dict_from_jax({"params": jax.tree_util.tree_map(
                np.asarray, g)}).items():
            named[name].grad = val
        opt.step()
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, params)})
    for name, val in want.items():
        got = named[name].detach().numpy()
        bar = np.maximum(1e-7, np.spacing(np.abs(val.numpy())))
        assert np.all(np.abs(got - val.numpy()) <= bar), name


def test_losses_and_their_grads_match_jax(small_assets):
    faces = small_assets.faces
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 0.1, (2, V, 3)).astype(np.float32)
    gt = rng.normal(0, 0.1, (2, V, 3)).astype(np.float32)
    valid = (rng.uniform(size=(2, V, 1)) < 0.7).astype(np.float32)
    lap = jlosses.build_laplacian(faces, V)
    np.testing.assert_array_equal(losses.build_laplacian(faces, V), lap)
    cases = {
        "coord_l1": (lambda p: losses.coord_l1_loss(
            p, torch.from_numpy(gt), torch.from_numpy(valid)),
            lambda p: jlosses.coord_l1_loss(p, gt, valid)),
        "normal": (lambda p: losses.normal_vector_loss(
            p, torch.from_numpy(gt), faces),
            lambda p: jlosses.normal_vector_loss(p, gt, faces)),
        "edge": (lambda p: losses.edge_length_loss(
            p, torch.from_numpy(gt), faces),
            lambda p: jlosses.edge_length_loss(p, gt, faces)),
        "laplacian": (lambda p: losses.laplacian_loss(p, lap),
                      lambda p: jlosses.laplacian_loss(p, lap)),
    }
    for name, (port_fn, jax_fn) in cases.items():
        t = torch.tensor(pred, requires_grad=True)
        val = port_fn(t)
        val.backward()
        jval, jgrad = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
        np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5,
                                   err_msg=name)
        scale = max(float(jnp.abs(jgrad).max()), 1e-12)
        np.testing.assert_allclose(t.grad.numpy() / scale,
                                   np.asarray(jgrad) / scale, atol=1e-5,
                                   err_msg=name)


def test_multistep_lr_matches_optax_schedule():
    sched = jschedule.multistep_lr(1e-3, [2, 5], 0.1, steps_per_epoch=7)
    port = multistep_lr(1e-3, [2, 5], 0.1, steps_per_epoch=7)
    for step in range(50):
        assert port(step) == pytest.approx(float(sched(step)), rel=1e-6)


def test_plateau_controller_matches_jax_and_round_trips():
    jctl = jschedule.ReduceLROnPlateau(1e-3, 0.5, patience=2)
    ctl = ReduceLROnPlateau(1e-3, 0.5, patience=2)
    for metric in (5.0, 4.0, 4.0, 4.0, 4.0, 3.99999, 3.0, 3.0, 3.0, 3.0):
        assert ctl.update(metric) == jctl.update(metric)
    other = ReduceLROnPlateau(1.0, 0.1)
    other.load_state_dict(ctl.state_dict())
    assert other.state_dict() == ctl.state_dict() == jctl.state_dict()
    assert other.update(2.0) == ctl.update(2.0)
