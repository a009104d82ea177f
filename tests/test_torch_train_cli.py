"""The port's training CLI (`gator_tpu_torch.cli.train`) against the JAX
package's training loop on the CPU, and the parts of it that the JAX loop
does not show: the LR on every update, `TRAIN.fused_kernels`, the steps
an epoch of the step schedule, and the convergence tool's `check`.

The CLI comparison runs both sides two epochs each, on the repo's configs
cut to size (depth 2, B=16, 48 synthetic training samples, f32,
`edge_loss_start: 1` so that the edge gate opens in epoch 2, one step a
dispatch), once with `scheduler: step` and a boundary after epoch 1 and
once with `platue`: per-epoch train loss and eval MPJPE/MPVPE within rtol
1e-4, and the plateau state after each epoch equal (its `best`, which is
an eval MPJPE, within the same rtol). The port runs `run_train` whole.
The JAX side is gator_tpu/cli/train.py's loop composed in the test from
the JAX package's own pieces, in the CLI's order (`run_jax`: its Session
pair, `make_optimizer`, `make_steps`, the edge gate, the f32 loss sum,
`run_eval`, the plateau update and `set_learning_rate`), on one device:
`gator_tpu.cli.train.main` compiles its step a second time in epoch 2
and writes orbax checkpoints, which doubles the test's time.
Monkeypatches, in the test only, give both sides the same start: the
890-vertex assets, the flax init converted by `state_dict_from_jax` (a
GAT config takes the lifter of its seed's GATOR init), and
every dropout rate 0 (flax's `Dropout` is the identity on the JAX side,
whose CPU session runs the module form; the port's steps get zero rates).
"""
import dataclasses
import importlib.util
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from gator_tpu.cli import common as jax_common
from gator_tpu.config import load_config as jax_load_config
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train import run_eval as jax_run_eval
from gator_tpu.train import schedule as jschedule
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.cli import common as cli_common
from gator_tpu_torch.cli import train as train_cli
from gator_tpu_torch.config import load_config
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
from gator_tpu_torch.train import (Adam, RMSprop, TrainState,
                                   load_checkpoint, make_optimizer,
                                   multistep_lr, set_learning_rate)
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 48
ZERO_GAT = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
CONFIGS = {"gator": "gator_synthetic_smoke.yml",
           "gat": "gat_synthetic_e2e.yml"}


def config(tmp_path, name, scheduler="step", **train):
    """The repo's config `name` cut to size, written where both packages
    read it."""
    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["depth"] = 2
    raw["TRAIN"].update({"batch_size": 16, "precision": "float32",
                         "edge_loss_start": 1, "print_freq": 100,
                         "steps_per_dispatch": 1, "scheduler": scheduler,
                         "lr": 1e-3, "lr_step": [1], "lr_factor": 0.5,
                         **train})
    raw["TEST"]["batch_size"] = 64
    path = tmp_path / f"{name[:-4]}_{scheduler}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    # the JAX Session turns on XLA's persistent cache: keep it in tmp_path
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))


@pytest.fixture(scope="module")
def port_assets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                        seed=0)


def zero_rate_steps(monkeypatch):
    """The port's train steps at every dropout rate 0."""
    gator = cli_common.make_gator_train_step
    gat = cli_common.make_gat_train_step

    def zero_gator(spec, *a, **kw):
        spec = dataclasses.replace(
            spec, gat=dataclasses.replace(spec.gat, **ZERO_GAT))
        return gator(spec, *a, rates=ZERO_RATES, gat_mlp_rate=0.0, **kw)

    def zero_gat(spec, **kw):
        return gat(dataclasses.replace(spec, **ZERO_GAT), mlp_rate=0.0,
                   **kw)

    monkeypatch.setattr(cli_common, "make_gator_train_step", zero_gator)
    monkeypatch.setattr(cli_common, "make_gat_train_step", zero_gat)


def start_from(monkeypatch, variables):
    """The port's sessions build their model from the JAX variables."""
    build = cli_common.Session.build_model

    def build_model(self):
        model = build(self)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return model

    monkeypatch.setattr(cli_common.Session, "build_model", build_model)


@pytest.fixture(scope="module")
def flax_inits():
    """{seed: the flax init}, each made once: it takes seconds to
    compile."""
    return {}


def jax_variables_of(sess, inits):
    """The flax init of the config's GATOR from its seed; a GAT config
    (the same joints, width and depth) takes that GATOR's lifter."""
    cfg = sess.cfg
    if cfg.seed not in inits:
        spec = JaxGatorSpec.from_assets(
            sess.assets, embed_dim=cfg.MODEL.embed_dim,
            depth=cfg.MODEL.depth, alpha=cfg.MODEL.alpha)
        inits[cfg.seed] = jax_variables(init_gator, spec, cfg.seed)
    v = inits[cfg.seed]
    return v if sess.is_gator else {"params": v["params"]["pose_lifter"]}


def run_jax(monkeypatch, cfg_path, jassets, inits):
    """gator_tpu/cli/train.py:60-249 composed from the JAX package's own
    pieces in the CLI's order, on one device, every flax dropout the
    identity -> (variables, per-epoch (loss, MPJPE, MPVPE, plateau
    state))."""
    cfg = jax_load_config(cfg_path)
    with monkeypatch.context() as mp:
        mp.setattr(flax_nn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        sess = jax_common.Session(cfg, is_train=True, synthetic=True,
                                  assets=jassets, synthetic_n=N)
        eval_sess = jax_common.Session(cfg, is_train=False, synthetic=True,
                                       assets=sess.assets)
        tx = sess.make_optimizer()
        train_step, eval_step = sess.make_steps(tx)
        variables = jax_variables_of(sess, inits)
        state = JaxTrainState.create(
            jax.tree_util.tree_map(jnp.asarray, variables), tx)
        step = jax.jit(train_step)
        rng = jax.random.PRNGKey(cfg.seed)
        epochs = []
        for epoch in (1, 2):
            sess.pipeline.set_epoch(epoch)
            edge_on = jnp.asarray(
                1.0 if (sess.is_gator and epoch > cfg.TRAIN.edge_loss_start)
                else 0.0)
            extra = (rng, edge_on) if sess.is_gator else (rng,)
            loss_sum, steps = jnp.asarray(0.0, jnp.float32), 0
            for batch in sess.pipeline:
                state, m = step(state, batch, *extra)
                loss_sum = loss_sum + m["loss"]
                steps += 1
            res = jax_run_eval(eval_step, state, eval_sess.pipeline)
            j_err = float(res.get("joint_err", np.inf))
            s_err = float(res.get("surface_err", np.inf))
            sched = {}
            if sess.plateau is not None:
                state = jschedule.set_learning_rate(
                    state, sess.plateau.update(j_err))
                sched = sess.plateau.state_dict()
            epochs.append((float(loss_sum) / steps, j_err, s_err, sched))
    return variables, epochs


def port_epochs(ckpt_dir):
    """Per-epoch (loss, MPJPE, MPVPE, plateau state) from the port run's
    checkpoint1 and final."""
    out = []
    for i, name in enumerate(("checkpoint1", "final")):
        c = load_checkpoint(os.path.join(ckpt_dir, f"{name}.pth.tar"))
        sched = {k: float(v) for k, v in c["scheduler_state_dict"].items()}
        out.append((c["train_log"][i], c["test_log"]["joint"][i],
                    c["test_log"]["surface"][i], sched))
    return out


@pytest.mark.parametrize("scheduler", ["step", "platue"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_cli_matches_jax_cli(case, scheduler, tmp_path, monkeypatch,
                             jax_cache, small_assets, port_assets,
                             flax_inits, capsys):
    cfg_path = config(tmp_path, CONFIGS[case], scheduler)
    variables, want = run_jax(monkeypatch, cfg_path, small_assets,
                              flax_inits)

    zero_rate_steps(monkeypatch)
    start_from(monkeypatch, variables)
    best = train_cli.run_train(load_config(cfg_path),
                               exp_dir=str(tmp_path / "port"),
                               synthetic=True, synthetic_n=N, epochs=2,
                               device="cpu", assets=port_assets)
    got = port_epochs(tmp_path / "port" / "checkpoint")
    for epoch, (g, w) in enumerate(zip(got, want), 1):
        for what, gv, wv in zip(("loss", "MPJPE", "MPVPE"), g[:3], w[:3]):
            if np.isinf(wv):         # a GAT run has no surface error
                assert np.isinf(gv), (epoch, what)
                continue
            np.testing.assert_allclose(gv, wv, rtol=1e-4,
                                       err_msg=f"epoch {epoch} {what}")
        # the plateau state: its lr and count exact, its best the MPJPE
        assert set(g[3]) == set(w[3]), epoch
        for k in g[3]:
            np.testing.assert_allclose(
                g[3][k], w[3][k], rtol=1e-4 if k == "best" else 0,
                err_msg=f"epoch {epoch} plateau {k}")
    assert (got[0][3] != {}) == (scheduler == "platue")
    np.testing.assert_allclose(best, min(w[1] for w in want), rtol=1e-4)
    if case == "gator":
        # the edge term is zero until the gate opens in epoch 2
        assert got[1][0] > 5 * got[0][0]
    out = capsys.readouterr().out
    assert "epoch 2 MPJPE" in out and "samples/s" in out


# -- the LR on every update ---------------------------------------------

SHAPES = {"w": (7, 5), "b": (5,)}
OPTIMIZERS = ["adam", "sgd", "rmsprop"]


def _params_and_grads(steps, seed=3):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 1e-2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _port_state(name, params, lr, schedule=None):
    module = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in params.items()})
    return TrainState(module, make_optimizer(name, module.parameters(), lr),
                      lr_schedule=schedule)


def _port_update(state, grads):
    for k, p in state.model.items():
        p.grad = torch.from_numpy(grads[k])
    state.apply_gradients()


def _assert_moves(state, jparams, step):
    """Every parameter within 1e-7, or an ulp of it for each update so
    far (tests/test_torch_training.py's Adam bar: XLA's CPU sqrt and rsqrt
    are not correctly rounded); an update moves it by ~1e-5 or more."""
    for k in SHAPES:
        want = np.asarray(jparams[k])
        got = state.model[k].detach().numpy()
        bar = np.maximum(1e-7, (step + 1) * np.spacing(np.abs(want)))
        assert np.all(np.abs(got - want) <= bar), (step, k)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_step_schedule_applies_on_every_update(name):
    """`multistep_lr` through `TrainState.lr_schedule` against optax's
    piecewise-constant schedule inside the optimizer, over six updates
    that cross two boundaries (epochs of 2 steps, drops after epochs 1
    and 2), each parameter compared after every update (`_assert_moves`).
    The same updates at the base lr alone move the parameters apart."""
    params, grads = _params_and_grads(6)
    tx = jschedule.make_optimizer(
        name, jschedule.multistep_lr(1e-3, (1, 2), 0.5, 2))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    state = _port_state(name, params, 1e-3,
                        multistep_lr(1e-3, (1, 2), 0.5, 2))
    flat = _port_state(name, params, 1e-3)
    lrs = []
    for s, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        _port_update(state, g)
        _port_update(flat, g)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        _assert_moves(state, jp, s)
    assert lrs == [1e-3] * 2 + [5e-4] * 2 + [2.5e-4] * 2
    assert state.step == 6
    assert np.abs(flat.model["w"].detach().numpy()
                  - state.model["w"].detach().numpy()).max() > 1e-6


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_set_learning_rate_matches_injected_lr(name):
    """`set_learning_rate` between updates against the JAX package's on
    an inject_hyperparams optimizer (the plateau path): the lr drops after
    the second update and again after the fourth."""
    from gator_tpu.train import TrainState as JaxTrainState

    params, grads = _params_and_grads(6, seed=5)
    tx = jschedule.make_optimizer(name, 1e-3, inject=True)
    jstate = JaxTrainState.create(
        {"params": {k: jnp.asarray(v) for k, v in params.items()}}, tx)
    state = _port_state(name, params, 1e-3)
    for s, g in enumerate(grads):
        if s in (2, 4):
            lr = 1e-3 * 0.3 ** (s // 2)
            jstate = jschedule.set_learning_rate(jstate, lr)
            assert set_learning_rate(state, lr) is state
        jstate = jstate.apply_gradients(
            tx, {k: jnp.asarray(v) for k, v in g.items()})
        _port_update(state, g)
        _assert_moves(state, jstate.params, s)
    assert [g["lr"] for g in state.optimizer.param_groups] == [
        pytest.approx(9e-5, rel=1e-12)]
    assert isinstance(state.optimizer, {"adam": Adam, "rmsprop": RMSprop,
                                        "sgd": torch.optim.SGD}[name])


# -- the config's optimizer, scheduler and kernel choice ----------------

def _session(tmp_path, port_assets, **train):
    cfg = load_config(config(tmp_path, CONFIGS["gator"], **train))
    return cli_common.Session(cfg, synthetic=True,
                              assets=port_assets, synthetic_n=32,
                              device="cpu", is_train=True)


@pytest.mark.parametrize("fused,match", [
    ("on", "needs the card"),
    ("off", "fused_kernels=off.*not ported"),
    ("sometimes", "must be 'auto', 'on' or 'off'")])
def test_fused_kernels_choice(tmp_path, port_assets, fused, match):
    """TRAIN.fused_kernels: 'on' raises on the CPU, 'off' (the module form
    with flax dropout, not ported) raises by name, and so does an unknown
    value; 'auto' trains on the kernels' plain versions here."""
    sess = _session(tmp_path, port_assets, fused_kernels=fused)
    with pytest.raises(ValueError, match=match):
        sess.make_train_step(sess.make_optimizer())
    auto = _session(tmp_path, port_assets)
    state, _ = auto.make_train_step(auto.make_optimizer())
    assert isinstance(state.optimizer, Adam)


def test_make_optimizer_follows_the_config(tmp_path, port_assets):
    """'step' gives a MultiStepLR over len(pipeline) steps an epoch on the
    state; 'platue' and 'plateau' give a constant lr and the session's
    ReduceLROnPlateau; anything else raises the JAX session's message."""
    sess = _session(tmp_path, port_assets, lr_step=[1, 2])
    factory = sess.make_optimizer()
    assert len(sess.pipeline) == 2 and sess.plateau is None
    assert [factory.schedule(s) for s in (0, 1, 2, 3, 4)] == [
        1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4]
    state, _ = sess.make_train_step(factory)
    assert state.lr_schedule is factory.schedule
    for name in ("platue", "plateau"):
        sess = _session(tmp_path, port_assets, scheduler=name,
                        optimizer="rmsprop")
        state, _ = sess.make_train_step(sess.make_optimizer())
        assert state.lr_schedule is None and isinstance(state.optimizer,
                                                        RMSprop)
        assert sess.plateau.state_dict() == {
            "lr": 1e-3, "best": float("inf"), "num_bad_epochs": 0}
    sess = _session(tmp_path, port_assets, scheduler="cosine")
    with pytest.raises(ValueError, match="unknown cfg.TRAIN.scheduler "
                       "'cosine' \\(expected 'step' or 'platue'\\)"):
        sess.make_optimizer()


@pytest.mark.parametrize("sizes,batch", [((48,), 16), ((50,), 16),
                                         ((40, 96, 7), 32), ((5, 3), 16)])
def test_steps_per_epoch_match_jax_pipeline(sizes, batch):
    """len(pipeline), the steps an epoch of the step schedule, with
    drop_last as a training session builds it, equals the JAX pipeline's
    for one dataset and for a mix."""
    from gator_tpu.data import BatchPipeline as JaxPipeline
    from gator_tpu_torch.data import BatchPipeline

    class Sized:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    ds = [Sized(n) for n in sizes]
    want = len(JaxPipeline(ds, None, batch, drop_last=True))
    assert len(BatchPipeline(ds, None, batch, drop_last=True)) == want


# -- the convergence tool ------------------------------------------------

def _load_tool(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convergence_check_matches_jax_tool():
    """The port's `check` returns the JAX tool's failures on the fixtures
    of tests/test_cli.py's edge-gate test and on a missing best
    checkpoint, a short run, no improvement and a diverged end."""
    from gator_tpu_torch.tools import run_convergence_cli as tool

    jtool = _load_tool(os.path.join(ROOT, "tools", "run_convergence_cli.py"),
                       "jax_convergence_cli")
    base = {"epochs": 8, "best_dir_exists": True,
            "eval_mpjpe_per_epoch": [320, 280, 250, 240, 230, 222, 218,
                                     215]}
    cases = [
        dict(base, train_loss_per_epoch=[0.57, 0.55, 0.53, 0.51, 3.84,
                                         3.62, 3.43, 3.11]),
        dict(base, train_loss_per_epoch=[0.57, 0.55, 0.53, 0.51, 3.84,
                                         3.9, 4.0, 4.2]),
        dict(base, train_loss_per_epoch=[0.57, 0.6, 0.65, 0.7, 3.84, 3.6,
                                         3.4, 3.1]),
        dict(base, train_loss_per_epoch=[0.5] * 8, best_dir_exists=False,
             eval_mpjpe_per_epoch=[320, 300, 290, 280, 270, 260, 250,
                                   400]),
        dict(base, epochs=12, train_loss_per_epoch=[0.5, 0.4]),
    ]
    seen = set()
    for result in cases:
        for gate in (4, 0):
            want = jtool.check(result, edge_loss_start=gate)
            assert tool.check(result, edge_loss_start=gate) == want
            seen.update(f.split(":")[0] for f in want)
    assert len(seen) >= 6, seen
