"""tools/jax_checkpoint_to_torch.py: a checkpoint that gator_tpu's own
`save_checkpoint` writes (an orbax directory, small assets) becomes a
`.pth.tar` that the port's `load_weights` and serve CLI load; the port's
mesh from it is within 1e-4 m of the JAX package's on the same poses. A
container directory resolves to best/ as gator_tpu's eval CLI resolves it,
and a concrete checkpoint{N}/ or final/ converts as it is."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gator_tpu.cli.test import load_weights as jax_load_weights
from gator_tpu.models import GATOR as JaxGATOR
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import save_checkpoint as jax_save_checkpoint
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import serve as serve_cli
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.data import processing
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.train import load_weights
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(ROOT, "tools", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variables(jspec, seed, alpha):
    variables = jax_variables(init_gator, jspec, seed)
    if not alpha:
        rng = np.random.default_rng(seed)
        bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _save(ckpt_dir, variables, epoch, **kw):
    # plain SGD keeps no optimizer state: the converter reads none
    state = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), optax.sgd(1e-3))
    return jax_save_checkpoint(ckpt_dir, state, epoch, **kw)


@pytest.mark.parametrize("joint_set,alpha", [("human36", False),
                                             ("coco", True)])
def test_converted_checkpoint_serves_within_1e4(joint_set, alpha, tmp_path,
                                                small_assets,
                                                small_assets_coco, capsys):
    jassets = {"human36": small_assets, "coco": small_assets_coco}[joint_set]
    jspec = JaxGatorSpec.from_assets(jassets, embed_dim=128, depth=2,
                                     alpha=alpha)
    best = _variables(jspec, 4, alpha)
    later = jax.tree_util.tree_map(lambda x: x * 0.5, best)
    ckpt = str(tmp_path / "ckpt")
    _save(ckpt, best, 3, is_best=True)       # checkpoint3/ and best/
    _save(ckpt, later, 5, is_final=True)     # final/, further along

    tool = _tool()
    out = str(tmp_path / "out" / "best.pth.tar")
    tool.main([ckpt, out])
    assert capsys.readouterr().out.strip() == \
        f"{os.path.join(ckpt, 'best')} -> {out}"
    payload = torch.load(out, map_location="cpu", weights_only=False)
    assert payload["epoch"] == 3
    assert payload["optim_state_dict"] == {}
    assert payload["scheduler_state_dict"] == {}
    # the JAX eval CLI resolves the container to the same weights
    want_state = state_dict_from_jax(jax_load_weights(ckpt, None))
    assert set(payload["model_state_dict"]) == set(want_state)
    for k, v in want_state.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    fin = str(tmp_path / "final.pth.tar")
    assert tool.convert(os.path.join(ckpt, "final"), fin) == \
        os.path.join(ckpt, "final")
    assert torch.load(fin, map_location="cpu",
                      weights_only=False)["epoch"] == 5

    passets = build_assets(joint_set, data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    model = build_gator(GatorSpec.from_assets(passets, embed_dim=128,
                                              depth=2, alpha=alpha),
                        seed=0, device="cpu")
    load_weights(model, out)
    j = jspec.gat.num_joint
    pose = np.random.default_rng(8).normal(size=(5, j, 2)).astype(np.float32)
    want, _ = jax.jit(lambda v, x: JaxGATOR(spec=jspec).apply(
        v, x, deterministic=True))(best, jnp.asarray(pose))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_serve_cli_on_converted_checkpoint(tmp_path, small_assets_coco):
    """The port's serve CLI (its full-depth coco model) on a converted
    gator_tpu checkpoint: meshes within 1e-4 m of the JAX module on the
    same preprocessed poses."""
    jspec = JaxGatorSpec.from_assets(small_assets_coco)
    variables = _variables(jspec, 6, False)
    ckpt = str(tmp_path / "ckpt")
    _save(ckpt, variables, 1, is_final=True)
    out = str(tmp_path / "w.pth.tar")
    _tool().convert(ckpt, out)

    passets = build_assets("coco", data_dirs=[], synthetic_vertex_num=890,
                           seed=0)
    rng = np.random.default_rng(9)
    poses = np.concatenate([rng.uniform(50, 450, (6, 17, 2)),
                            rng.uniform(0.3, 1.0, (6, 17, 1))], 2)
    src = tmp_path / "poses.npy"
    np.save(src, poses.astype(np.float32))
    served = serve_cli.run_serve(str(src), "coco", weights=out,
                                 output=str(tmp_path / "m.npy"),
                                 dtype="float32", device="cpu",
                                 assets=passets)
    pose2d = processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses.astype(np.float32),
            list(passets.joint_set.joints_name))[..., :2],
        passets.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name="coco"),
        np.zeros(6, np.int64), np.zeros(6, np.float32))
    want, _ = jax.jit(lambda v, x: JaxGATOR(spec=jspec).apply(
        v, x, deterministic=True))(variables, jnp.asarray(pose2d))
    np.testing.assert_allclose(served["meshes"], np.asarray(want),
                               atol=1e-4, rtol=0)
