"""The port's optimizers against the JAX package's optax ones, and its
`load_weights` on a checkpoint in the reference's released layout.

- `make_optimizer("sgd")` and `("rmsprop")` take the same two gradients on
  the same parameters as `gator_tpu.train.schedule.make_optimizer`'s
  optax transforms: each parameter's change within rtol 1e-6 (an ulp or
  two of the update; rsqrt is not correctly rounded on either side).
- A JAX-exported state dict (`export_state_dict`) with the four buffers a
  released reference `.pth.tar` carries loads through `load_weights` and
  serves the JAX package's mesh within 1e-4 m; an unknown key or a missing
  parameter still raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gator_tpu.convert import export_state_dict
from gator_tpu.models import GATOR as JaxGATOR
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.train import schedule as jax_schedule
from test_torch_convert import jax_variables
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.serving import make_serving_fn
from gator_tpu_torch.train import RMSprop, load_weights, make_optimizer

SHAPES = {"w": (7, 5), "b": (5,), "v": (3, 4, 2)}
# the buffers of a released checkpoint that the port rebuilds from assets
# (tests/test_reference_parity.py)
RELEASED_BUFFERS = ("pose_lifter.graph_adj", "pose_lifter.init_vertices",
                    "pose2mesh.init_vertices", "pose2mesh.init_vertices_6890")


def _grads(rng, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
@pytest.mark.parametrize("scale", [1e-2, 1e-5])
def test_optimizer_matches_optax_for_two_steps(name, scale):
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [_grads(rng, scale) for _ in range(2)]

    tx = jax_schedule.make_optimizer(name, 1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(name, tp.values(), lr=1e-3)
    assert isinstance(opt, RMSprop if name == "rmsprop"
                      else torch.optim.SGD)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in SHAPES:
        want = np.asarray(jp[k]) - params[k]
        got = tp[k].detach().numpy() - params[k]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)


def test_rmsprop_adds_eps_inside_the_square_root():
    """One step at lr 1e-3 on a gradient of 1e-5 moves a parameter by
    -lr * g / sqrt((1 - 0.9) g^2 + 1e-8) = -1.0e-4 (optax), not by
    -lr * g / (sqrt((1 - 0.9) g^2) + 1e-8) = -3.15e-3 (torch's RMSprop)."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = make_optimizer("rmsprop", [p], lr=1e-3)
    p.grad = torch.full((1,), 1e-5)
    opt.step()
    want = -1e-3 * 1e-5 / np.sqrt(0.1 * 1e-10 + 1e-8)
    np.testing.assert_allclose(p.item(), want, rtol=1e-6)
    assert abs(p.item() + 1.0e-4) < 1e-6


@pytest.fixture(scope="module", params=[False, True], ids=["h36m", "alpha"])
def released(request, small_assets, tmp_path_factory):
    """(JAX spec, JAX variables, path of a reference-layout checkpoint of
    the same weights, port spec)."""
    alpha = request.param
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=128, depth=2,
                                     alpha=alpha)
    variables = jax_variables(init_gator, jspec, 8)
    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    spec = GatorSpec.from_assets(passets, embed_dim=128, depth=2,
                                 alpha=alpha)
    state = {f"module.{k}": torch.from_numpy(np.array(v))
             for k, v in export_state_dict(variables).items()}
    if not alpha:  # torch's BatchNorm counter, which a released file holds
        state["module.pose2mesh.bias_norm.num_batches_tracked"] = \
            torch.tensor(0)
    for key in RELEASED_BUFFERS:
        state[f"module.{key}"] = torch.zeros(3, 3)
    path = tmp_path_factory.mktemp("released") / "final.pth.tar"
    torch.save({"epoch": 1, "model_state_dict": state}, path)
    return jspec, variables, path, spec


def test_released_checkpoint_loads_and_serves_the_jax_mesh(released):
    jspec, variables, path, spec = released
    model = load_weights(GATOR(spec), str(path)).eval()
    pose = np.random.default_rng(4).normal(size=(3, 17, 2)).astype(
        np.float32)
    mesh, _ = make_serving_fn(model, dtype=torch.float32)(
        torch.from_numpy(pose))
    want, _ = jax.jit(lambda v, x: JaxGATOR(spec=jspec).apply(
        v, x, deterministic=True))(variables, jnp.asarray(pose))
    np.testing.assert_allclose(mesh.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("change", ["unknown", "missing"])
def test_load_weights_stays_strict_on_other_keys(released, tmp_path, change):
    _, _, path, spec = released
    payload = torch.load(path, weights_only=False)
    state = payload["model_state_dict"]
    if change == "unknown":
        state["module.pose2mesh.extra_weight"] = torch.zeros(2)
    else:
        del state["module.pose2mesh.bias_linear.weight"]
    bad = tmp_path / "bad.pth.tar"
    torch.save(payload, bad)
    with pytest.raises(RuntimeError, match="Unexpected key|Missing key"):
        load_weights(GATOR(spec), str(bad))
