"""Resuming a run in the port's training CLI, on the CPU.

- `--resume_training` after one epoch gives a second epoch bit-equal to
  an uninterrupted two-epoch run's: weights, BatchNorm stats, optimizer
  state, step and histories, at the configs' own dropout rates (the step
  keys the masks) and across a step-schedule boundary, or with the
  plateau controller.
- A SIGTERM in epoch 2 finishes the step, writes checkpoint1.pth.tar,
  returns and gives the caller's handler back; the resumed run finishes
  and ends bit-equal to the uninterrupted one.
- The stage-2 lifter of a two-stage run equals the stage-1 best
  checkpoint (with or without the reference's "module." prefix).
- A JAX TrainState that gator_tpu's `save_checkpoint` wrote after two
  Adam steps, converted by tools/jax_checkpoint_to_torch.py, resumes in
  the port: one more step at zero rates on each side gives losses within
  rtol 1e-5 and parameters, scaled by their max, within 5e-4
  (tests/test_torch_training.py's bars), for a step-scheduled Adam whose
  third step crosses a boundary and for an inject_hyperparams (plateau)
  Adam whose lr was reset. The converted SGD and RMSprop states take the
  same next update as optax.
"""
import importlib.util
import os
import signal

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gator_tpu import losses as jlosses
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import save_checkpoint as jax_save_checkpoint
from gator_tpu.train import schedule as jschedule
from gator_tpu.train.loop import make_gator_train_step as jax_gator_step
from gator_tpu_torch import losses
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import common as cli_common
from gator_tpu_torch.cli import train as train_cli
from gator_tpu_torch.config import load_config
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.data.pipeline import BatchPipeline
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
from gator_tpu_torch.train import (Adam, TrainState, load_checkpoint,
                                   make_gator_train_step, make_optimizer,
                                   multistep_lr)
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import ZERO_GAT, _batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 48
V = 890


@pytest.fixture(scope="module")
def passets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=V,
                        seed=0)


def _config(tmp_path, scheduler, name="gator_synthetic_smoke.yml",
            model=None):
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"].update({"depth": 2, **(model or {})})
    raw["TRAIN"].update({"batch_size": 16, "precision": "float32",
                         "edge_loss_start": 1, "print_freq": 100,
                         "scheduler": scheduler, "lr": 1e-3,
                         "lr_step": [1], "lr_factor": 0.5})
    raw["TEST"]["batch_size"] = 64
    path = tmp_path / f"{name[:-4]}_{scheduler}_{len(model or {})}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _train(cfg_path, exp_dir, passets, epochs, resume=False):
    return train_cli.run_train(load_config(cfg_path), exp_dir=str(exp_dir),
                               synthetic=True, synthetic_n=N, epochs=epochs,
                               resume=resume, device="cpu", assets=passets)


def _assert_same_run(got_dir, want_dir):
    got = load_checkpoint(os.path.join(got_dir, "checkpoint",
                                       "final.pth.tar"))
    want = load_checkpoint(os.path.join(want_dir, "checkpoint",
                                        "final.pth.tar"))
    assert got["epoch"] == want["epoch"] == 2
    assert got["step"] == want["step"] == 6
    assert got["train_log"] == want["train_log"]
    assert got["test_log"] == want["test_log"]
    assert got["scheduler_state_dict"] == want["scheduler_state_dict"]
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    go, wo = got["optim_state_dict"], want["optim_state_dict"]
    assert go["param_groups"] == wo["param_groups"]
    assert set(go["state"]) == set(wo["state"])
    for i, st in wo["state"].items():
        # Adam's own count stays the train step
        assert go["state"][i]["step"] == st["step"] == 6
        for k in ("mu", "nu"):
            assert torch.equal(go["state"][i][k], st[k]), (i, k)


@pytest.fixture(scope="module")
def straight(tmp_path_factory, passets):
    """-> run(scheduler) = (config, the directory of an uninterrupted
    two-epoch run of it), each run made once."""
    runs = {}

    def run(scheduler):
        if scheduler not in runs:
            tmp = tmp_path_factory.mktemp(f"straight_{scheduler}")
            cfg = _config(tmp, scheduler)
            _train(cfg, tmp / "run", passets, 2)
            runs[scheduler] = cfg, tmp / "run"
        return runs[scheduler]

    return run


@pytest.mark.parametrize("scheduler", ["step", "platue"])
def test_resume_after_one_epoch_is_bit_equal(scheduler, tmp_path, passets,
                                             straight):
    cfg, want = straight(scheduler)
    _train(cfg, tmp_path / "resumed", passets, 1)
    first = load_checkpoint(str(tmp_path / "resumed" / "checkpoint"
                                / "final.pth.tar"))
    assert first["epoch"] == 1 and first["step"] == 3
    _train(cfg, tmp_path / "resumed", passets, 2, resume=True)
    _assert_same_run(tmp_path / "resumed", want)


def test_sigterm_writes_a_resumable_checkpoint(tmp_path, passets,
                                               monkeypatch, capsys,
                                               straight):
    cfg, want = straight("step")
    set_epoch = BatchPipeline.set_epoch

    def term_in_epoch_2(self, epoch):
        set_epoch(self, epoch)
        if epoch == 2 and self.drop_last:      # the training pipeline
            signal.raise_signal(signal.SIGTERM)

    def before(signum, frame):
        raise AssertionError("the caller's handler ran")

    previous = signal.signal(signal.SIGTERM, before)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(BatchPipeline, "set_epoch", term_in_epoch_2)
            _train(cfg, tmp_path / "run", passets, 2)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)
    out = capsys.readouterr().out
    assert "preempted at epoch 2 step 1; checkpoint1 written" in out
    ckpt = tmp_path / "run" / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["best.pth.tar",
                                        "checkpoint1.pth.tar"]
    # the state epoch 2 began with: epoch 1's, not the step after it
    assert load_checkpoint(str(ckpt / "checkpoint1.pth.tar"))["step"] == 3
    _train(cfg, tmp_path / "run", passets, 2, resume=True)
    assert "resumed from epoch 1 (step 3)" in capsys.readouterr().out
    _assert_same_run(tmp_path / "run", want)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_stage2_lifter_is_the_stage1_best(prefix, tmp_path, passets,
                                          monkeypatch):
    s1_cfg = _config(tmp_path, "step",
                     model={"name": "GAT", "posenet_pretrained": False})
    _train(s1_cfg, tmp_path / "s1", passets, 2)
    s1_dir = tmp_path / "s1" / "checkpoint"
    best = load_checkpoint(str(s1_dir / "best.pth.tar"))
    if prefix:
        best["model_state_dict"] = {
            prefix + k: v for k, v in best["model_state_dict"].items()}
        torch.save(best, s1_dir / "best.pth.tar")
    s2_cfg = _config(tmp_path, "platue",
                     model={"posenet_pretrained": True,
                            "posenet_path": str(s1_dir)})
    seen = {}
    make = cli_common.Session.make_train_step

    def spy(self, optimizer):
        seen["state"], step = make(self, optimizer)
        return seen["state"], step

    monkeypatch.setattr(cli_common.Session, "make_train_step", spy)
    _train(s2_cfg, tmp_path / "s2", passets, 0)
    lifter = seen["state"].model.pose_lifter.state_dict()
    assert set(lifter) == {k[len(prefix):]
                           for k in best["model_state_dict"]}
    for k, v in best["model_state_dict"].items():
        assert torch.equal(lifter[k[len(prefix):]], v), k


# -- a gator_tpu run continued in the port ------------------------------

def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(ROOT, "tools", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_gator(small_assets):
    """JAX spec, variables (random BatchNorm stats) and a port model spec
    of one small human36 GATOR (alpha False) at zero GAT rates."""
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=64, depth=1,
                                     **ZERO_GAT)
    variables = jax_variables(init_gator, jspec, 4)
    rng = np.random.default_rng(4)
    bn = variables["batch_stats"]["pose2mesh"]["bias_norm"]
    bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    passets = build_assets("human36", data_dirs=[], synthetic_vertex_num=V,
                           seed=0)
    return jspec, variables, GatorSpec.from_assets(
        passets, embed_dim=64, depth=1, **ZERO_GAT), passets


@pytest.mark.parametrize("kind", ["step", "plateau"])
def test_converted_jax_run_resumes_in_the_port(kind, tmp_path, small_gator,
                                               small_assets, monkeypatch):
    jspec, variables, pspec, passets = small_gator
    if kind == "step":
        # 1 step an epoch, a drop after epoch 2: update 2 crosses it
        tx = jschedule.make_optimizer(
            "adam", jschedule.multistep_lr(1e-3, (2,), 0.1, 1))
    else:
        tx = jschedule.make_optimizer("adam", 1e-3, inject=True)
    batches = [_batch(17, 30 + i) for i in range(3)]
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)), tx)
    args = (jstate, {k: jnp.asarray(v) for k, v in batches[0].items()},
            jax.random.PRNGKey(0), jnp.asarray(1.0))
    # compiled without XLA's backend optimisations, as `jax_variables`
    step = jax.jit(jax_gator_step(
        jspec, small_assets.faces, small_assets.j_regressor_h36m,
        jlosses.LossWeights(), tx, dtype=jnp.float32)).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    for s, b in enumerate(batches):
        if s == 2:
            plateau = {"lr": 1e-3, "best": 80.0, "num_bad_epochs": 0}
            if kind == "plateau":
                plateau["lr"] = 3e-4
                jstate = jschedule.set_learning_rate(jstate, 3e-4)
            jax_save_checkpoint(str(tmp_path / "jax"), jstate, 2,
                                train_log=[1.5, 1.2],
                                test_log={"joint": [90.0, 80.0],
                                          "surface": [99.0, 95.0]},
                                scheduler_state=plateau)
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(0), jnp.asarray(1.0))

    dst = tmp_path / "port.pth.tar"
    _converter().convert(str(tmp_path / "jax" / "checkpoint2"), str(dst))
    model = GATOR(pspec)
    state = TrainState(model, Adam(model.parameters(), lr=1e-3),
                       lr_schedule=(multistep_lr(1e-3, (2,), 0.1, 1)
                                    if kind == "step" else None))
    got = load_checkpoint(str(dst), target_state=state)
    assert got["state"] is state and state.step == 2
    assert got["epoch"] == 2 and got["train_log"] == [1.5, 1.2]
    assert got["test_log"] == {"joint": [90.0, 80.0],
                               "surface": [99.0, 95.0]}
    assert got["scheduler_state_dict"] == plateau
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        plateau["lr"] if kind == "plateau" else 1e-3, rel=1e-6)
    pstep = make_gator_train_step(pspec, passets.faces,
                                  passets.j_regressor_h36m,
                                  losses.LossWeights(), rates=ZERO_RATES,
                                  gat_mlp_rate=0.0)
    pm = pstep(state, {k: torch.from_numpy(v) for k, v in
                       batches[2].items()}, seed=0, edge_enabled=1.0)
    assert state.step == 3
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    got_sd = model.state_dict()
    assert set(got_sd) == set(want)
    for name, w in want.items():
        g, w = got_sd[name].float().numpy(), w.float().numpy()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_converted_optimizer_state_takes_the_optax_update(
        name, tmp_path, small_gator):
    """The optimizer states of all three optimizers, mapped by the weight
    converter's names: after two optax updates, the converted state in the
    port and optax take the same third update, which moves parameters by
    more than 1e-5: each parameter within 1e-7 or one ulp of optax's
    (tests/test_torch_training.py's Adam bar; XLA's CPU sqrt and rsqrt
    are not correctly rounded). A lost momentum or second moment moves
    them by the size of an update."""
    _, variables, pspec, _ = small_gator
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 1e-2, p.shape), jnp.float32),
        params) for _ in range(3)]
    tx = jschedule.make_optimizer(name, 1e-3)
    jstate = JaxTrainState.create(
        {"params": params, "batch_stats": variables["batch_stats"]}, tx)
    update = jax.jit(lambda st, g: st.apply_gradients(tx, g))
    for g in grads[:2]:
        jstate = update(jstate, g)
    jax_save_checkpoint(str(tmp_path / "jax"), jstate, 1)
    before = jstate.params
    jstate = update(jstate, grads[2])

    dst = tmp_path / "port.pth.tar"
    _converter().convert(str(tmp_path / "jax" / "checkpoint1"), str(dst))
    model = GATOR(pspec)
    state = TrainState(model, make_optimizer(name, model.parameters(),
                                             lr=1e-3))
    load_checkpoint(str(dst), target_state=state)
    assert state.step == 2
    named = dict(model.named_parameters())
    for n, g in state_dict_from_jax({"params": jax.tree_util.tree_map(
            np.asarray, grads[2])}).items():
        named[n].grad = g
    state.apply_gradients()
    start = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, before)})
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params)})
    moved = 0.0
    for n, w in want.items():
        w, got = w.numpy(), named[n].detach().numpy()
        bar = np.maximum(1e-7, np.spacing(np.abs(w)))
        assert np.all(np.abs(got - w) <= bar), n
        moved = max(moved, np.abs(w - start[n].numpy()).max())
    assert moved > 1e-5
