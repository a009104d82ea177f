"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a cell's run on the CPU at a small batch
(the harness's look for a card skipped), with one fault planted in the
program: an answer altered where it is produced, half of the batch left
out, a step that leaves its state unchanged. The fault-free run at the
same size is correct, so the catching number is the fault's."""
import pytest
import torch

from benchmark.core import check, spec
from benchmark.tests import cells

SERVE = "serve-b2048.gator-h36m17"
FLAGSHIP = "train2-flagship-b512.gator-coco19"


def serve_run(monkeypatch, wrap=None):
    drv = spec.driver("serve_closed")
    if wrap is not None:
        make = drv.make_program
        monkeypatch.setattr(drv, "make_program",
                            lambda model, dtype: wrap(make(model, dtype)))
    mix = cells.small_mix(SERVE)
    res = cells.run(SERVE, mix, seconds=0.5)
    return check.judge(res.values, mix["limits"])


def test_serve_sound_run_is_correct(monkeypatch):
    ok, checks = serve_run(monkeypatch)
    assert ok, checks


def test_serve_answer_altered(monkeypatch):
    def wrap(serve):
        def broken(x):
            mesh, pose3d = serve(x)
            mesh = mesh.clone()
            mesh[0] += 0.05                 # one pose's mesh 5 cm off
            return mesh, pose3d
        return broken
    ok, checks = serve_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_row_rel_rms_max"]["value"] > \
        checks["mesh_row_rel_rms_max"]["limit"]


def test_serve_half_batch_left_out(monkeypatch):
    def wrap(serve):
        def broken(x):
            b = x.shape[0] // 2
            mesh, pose3d = serve(x[:b])
            return (torch.cat([mesh, torch.zeros_like(mesh)]),
                    torch.cat([pose3d, torch.zeros_like(pose3d)]))
        return broken
    ok, checks = serve_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_rel_rms"]["value"] > checks["mesh_rel_rms"]["limit"]


def train_run(monkeypatch, fault=None):
    parts = cells.parts(FLAGSHIP)
    drv = parts["driver"]
    cells.small_recipe(monkeypatch, drv)
    if fault is not None:
        build = drv.build

        def broken_build(ctx):
            rc, assets, sess, state, step, w = build(ctx)
            return (rc, assets, sess, state) + fault(state, step) + (w,)
        monkeypatch.setattr(drv, "build", broken_build)
    mix = cells.small_mix(FLAGSHIP)
    res = cells.run(FLAGSHIP, mix)
    print(res.values)
    return check.judge(res.values, mix["limits"]) + (res.values,)


def rewrap(step, inner=None, assemble=None):
    """A step composed as the port's wrapped step is, with its inner step
    or its assembly replaced."""
    inner = inner or step.inner
    assemble = assemble or step.assemble

    def broken(state, batch, *extra):
        return inner(state, assemble(state, batch, *extra), *extra)
    broken.inner, broken.assemble = inner, assemble
    return (broken,)


def test_train_sound_run_is_correct(monkeypatch):
    """At this size the worst leaves' bf16 noise is larger than at the
    cell's batch; the numbers that catch the faults below hold."""
    ok, checks, _ = train_run(monkeypatch)
    for name in ("pose2d_max_abs", "mesh_target_max_abs_m",
                 "delta_norm_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks


def test_train_state_unchanged(monkeypatch):
    def fault(state, step):
        state.optimizer.step = lambda *a, **k: None
        return (step,)
    ok, checks, _ = train_run(monkeypatch, fault)
    assert not ok
    assert checks["delta_norm_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out(monkeypatch):
    def fault(state, step):
        inner = step.inner

        def half(state, batch, *extra):
            b = batch["pose2d"].shape[0] // 2
            return inner(state, {k: v[:b] for k, v in batch.items()},
                         *extra)
        return rewrap(step, inner=half)
    ok, checks, values = train_run(monkeypatch, fault)
    assert not ok
    assert checks["delta_norm_gap_median"]["value"] > \
        checks["delta_norm_gap_median"]["limit"]
    assert values["loss_rel_max"] > 1e-2


def test_train_answer_altered(monkeypatch):
    def fault(state, step):
        assemble = step.assemble

        def altered(state, batch, *extra):
            out = dict(assemble(state, batch, *extra))
            out["pose2d"] = out["pose2d"].clone()
            out["pose2d"][0] += 0.1         # one row's 2D input
            return out
        return rewrap(step, assemble=altered)
    ok, checks, _ = train_run(monkeypatch, fault)
    assert not ok
    assert checks["pose2d_max_abs"]["value"] > \
        checks["pose2d_max_abs"]["limit"]
