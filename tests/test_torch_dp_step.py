"""The port's data-parallel train step on the CPU: 2 gloo ranks
(`parallel.spawn`) against one process on the global batch, and against
the JAX package's `jit_data_parallel` step on a 2-device mesh.

- At the training dropout rates, on the kernels' plain versions, in f32:
  the stage-2 step (BatchNorm head, seeded running stats), the stage-1
  step, and one `device`-mode step of a training Session on the synthetic
  H36M + COCO + MuCo mix (detector noise drawn in the step, flips and
  rotations on). Bars: loss rtol 1e-5; every gradient, scaled by its max,
  within 1e-5; the parameters after one Adam step at lr 1e-5 atol 1e-6
  (LR's comment says why that lr); the running
  stats atol 1e-6. The attention key biases have a zero true gradient:
  their gradients are held to an absolute 1e-5 and their Adam updates to
  the learning rate, which bounds any Adam step.
- At every rate 0, with the same converted weights, the 2-rank step
  against the JAX step sharded over 2 CPU devices (its module form with
  flax Dropout the identity: the interpret-mode kernels' host callbacks
  cannot be sharded), with the bars of
  tests/test_torch_training.py: loss terms rtol 1e-5, scaled gradients
  5e-4, running stats atol 1e-5.
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gator_tpu import losses as jlosses
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.parallel import make_mesh, replicate, shard_batch
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import jit_data_parallel
from gator_tpu.train.loop import make_gator_train_step as jax_gator_step
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.config import load_config
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
from gator_tpu_torch.parallel import spawn
from gator_tpu_torch.parallel.checks import run_cases
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import ZERO_GAT, _assert_grads, _capture_grads

# Adam's first update of an element is lr * g / (|g| + 1e-8): for a gradient
# near 1e-8 it turns the ranks' f32 sum-order noise (~1e-9 there) into up
# to lr * 0.1 of the update; at lr 1e-5 that stays inside the 1e-6 bar
V, B, LR = 890, 8, 1e-5
SPEC = {"embed_dim": 64, "depth": 2}


def _zero_grad_bias(name):
    """Parameters whose true gradient is zero (a key bias shifts every
    score of a query alike) -> the slice of it that is, or None."""
    if name.endswith("attn.qkv.bias"):
        return slice(64, 128)
    if "selfatt" in name and name.endswith("linears.1.bias"):
        return slice(None)
    return None


def _stage2_batch(b, j, seed):
    rng = np.random.default_rng(seed)
    return {
        "pose2d": (0.5 + 0.25 * rng.standard_normal((b, j, 2))).astype(
            np.float32),
        "mesh": rng.normal(size=(b, V, 3)).astype(np.float32) * 0.1,
        "lift_pose3d": rng.normal(size=(b, j, 3)).astype(np.float32) * 100,
        "reg_pose3d": rng.normal(size=(b, 17, 3)).astype(np.float32) * 100,
        "mesh_valid": (rng.uniform(size=(b, 1, 1)) < 0.8).astype(np.float32),
        "lift_valid": np.ones((b, j, 1), np.float32),
        "reg_valid": np.ones((b, 17, 1), np.float32),
    }


def _stage1_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {
        "pose2d": (0.5 + 0.25 * rng.standard_normal((b, 17, 2))).astype(
            np.float32),
        "joint_cam": rng.normal(size=(b, 17, 3)).astype(np.float32) * 100,
        "joint_valid": (rng.uniform(size=(b, 17, 1)) < 0.9).astype(
            np.float32),
    }


def _bn_state(assets):
    """Seeded weights with non-trivial BatchNorm running stats."""
    model = build_gator(GatorSpec.from_assets(assets, **SPEC), seed=2,
                        device="cpu")
    rng = np.random.default_rng(3)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    sd["pose2mesh.bias_norm.running_mean"] = rng.normal(
        0, 0.5, sd["pose2mesh.bias_norm.running_mean"].shape).astype(
        np.float32)
    sd["pose2mesh.bias_norm.running_var"] = rng.uniform(
        0.5, 2, sd["pose2mesh.bias_norm.running_var"].shape).astype(
        np.float32)
    return sd


def _mix_cfg():
    return load_config(None, {
        "seed": 0,
        "DATASET": {"train_list": ["Human36M", "COCO", "MuCo"],
                    "test_list": ["PW3D"], "input_joint_set": "coco",
                    "target_joint_set": "human36", "use_gt_input": False},
        "MODEL": {"name": "GATOR", "alpha": True, **SPEC},
        "TRAIN": {"batch_size": B, "gt_in_step": "device",
                  "precision": "float32", "lr": LR},
        "AUG": {"flip": True, "rotate_factor": 30.0}})


@pytest.fixture(scope="module")
def passets():
    return {js: build_assets(js, data_dirs=[], synthetic_vertex_num=V,
                             seed=0) for js in ("human36", "coco")}


@pytest.fixture(scope="module")
def jax_case(small_assets):
    """Converted JAX weights (every rate 0) and a 4-sample batch."""
    jspec = JaxGatorSpec.from_assets(small_assets, **SPEC, alpha=False,
                                     **ZERO_GAT)
    variables = jax_variables(init_gator, jspec, 0)
    rng = np.random.default_rng(3)
    bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
    bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)
    return jspec, variables, _stage2_batch(4, 17, 5)


@pytest.fixture(scope="module")
def cases(passets, jax_case):
    _, variables, jbatch = jax_case
    h36 = passets["human36"]
    return {
        "stage2": {"kind": "step", "assets": h36, "spec": SPEC,
                   "state_dict": _bn_state(h36),
                   "batch": _stage2_batch(B, 17, 5), "seed": 11, "lr": LR},
        "stage1": {"kind": "step", "stage": "gat", "assets": h36,
                   "spec": SPEC, "model_seed": 4,
                   "batch": _stage1_batch(B, 6), "seed": 12, "lr": LR},
        "device": {"kind": "session", "assets": passets["coco"],
                   "cfg": _mix_cfg(), "synthetic_n": 16, "seed": 13,
                   "lr": LR},
        "jax": {"kind": "step", "assets": h36, "spec": {**SPEC, **ZERO_GAT},
                "state_dict": {k: v.numpy() for k, v in
                               state_dict_from_jax(variables).items()},
                "batch": jbatch, "rates": ZERO_RATES, "gat_mlp_rate": 0.0,
                "seed": 0, "lr": 0.0},
    }


@pytest.fixture(scope="module")
def two_ranks(cases):
    """Every case over 2 gloo ranks, in one group of processes."""
    names = list(cases)
    ranks = spawn(run_cases, 2, args=([cases[n] for n in names],),
                  timeout=240)
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


def _hold(got, want):
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        g = got["grads"][name]
        zero = _zero_grad_bias(name)
        if zero is not None:
            assert np.abs(g[zero]).max() < 1e-5, name
            keep = np.ones(g.shape, bool)
            keep[zero] = False
            g, w = g[keep], w[keep]
        if g.size:
            scale = max(np.abs(w).max(), 1e-6)
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-5,
                                       rtol=0, err_msg=f"grad {name}")
    for name, w in want["params"].items():
        g = got["params"][name]
        zero = _zero_grad_bias(name)
        if zero is not None:
            # any Adam step moves a parameter by at most lr
            assert np.abs(g[zero] - w[zero]).max() <= 1.01 * LR, name
            keep = np.ones(g.shape, bool)
            keep[zero] = False
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                   err_msg=f"param {name}")
    for name, w in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][name], w,
                                   atol=1e-6, rtol=0, err_msg=name)
    assert got["step"] == want["step"] == 1


@pytest.mark.parametrize("name", ["stage2", "stage1", "device"])
def test_two_ranks_equal_one_process_on_the_global_batch(name, cases,
                                                         two_ranks):
    want = run_cases(None, [cases[name]])[0]
    r0, r1 = two_ranks[name]
    if name == "device":
        assert r0["mode"] == r1["mode"] == want["mode"] == "device"
    for got in (r0, r1):
        _hold(got, want)
    # the global metrics on every rank
    assert r0["metrics"] == r1["metrics"]


def test_two_ranks_match_jax_data_parallel_step(small_assets, jax_case,
                                                two_ranks, monkeypatch):
    jspec, variables, batch = jax_case
    tx = _capture_grads()
    # the module form (the interpret-mode kernels' host callbacks do not
    # shard), every flax Dropout the identity: every rate 0
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    step = jax_gator_step(jspec, small_assets.faces,
                          small_assets.j_regressor_h36m,
                          jlosses.LossWeights(), tx, dtype=jnp.float32)
    mesh = make_mesh(jax.devices()[:2])
    state = replicate(mesh, JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)), tx))
    jstate, jm = jit_data_parallel(step, mesh)(
        state, shard_batch(mesh, batch), jax.random.PRNGKey(0),
        jnp.asarray(1.0))
    jgrads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jstate.opt_state)})
    bn = jstate.batch_stats["pose2mesh"]["bias_norm"]
    for got in two_ranks["jax"]:
        for key in ("loss", "vertex", "normal", "edge", "reg_joint",
                    "lift_joint"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        _assert_grads({k: _Grad(v) for k, v in got["grads"].items()},
                      jgrads)
        np.testing.assert_allclose(
            got["buffers"]["pose2mesh.bias_norm.running_mean"],
            np.asarray(bn["mean"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            got["buffers"]["pose2mesh.bias_norm.running_var"],
            np.asarray(bn["var"]), atol=1e-5, rtol=0)


class _Grad:
    """A numpy gradient where `_assert_grads` expects a tensor."""

    def __init__(self, a):
        self.a = a

    def numpy(self):
        return self.a
