"""The port's in-step input paths of one dataset (TRAIN.gt_in_step "on"
and "full": data/device_pipeline.py, `train.loop.with_gt_synthesis`, the
readers' raw and index batches) against the JAX package's, on the CPU.

Both packages read one SmplTable (the JAX synthetic dataset's), so the
host halves are bit-equal: the raw and index batches from one rng, and the
torch forms of the crop, flip/standardise and 3D augmentation within 1e-6
of the jnp forms. The batches the wrapped steps assemble (caught by a step
that returns them) match the JAX package's on the same rows, flips and
rotations: pose2d within 1e-5, mesh within 2e-6 m, joints within 2e-3 mm,
masks equal (tests/test_packed.py's bars). One stage-2 step through the
"full" wrapper matches the JAX fused step at every dropout rate 0, in f32,
at tests/test_torch_training.py's bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu import losses as jlosses
from gator_tpu.assets import smpl_assets as jsmpl_assets
from gator_tpu.data import device_pipeline as jdp
from gator_tpu.data import processing as jproc
from gator_tpu.data.gt_synth import GtSynthesizer as JaxSynth
from gator_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu.nn.pallas_mdr_train import ZERO_RATES as JAX_ZERO
from gator_tpu.train import TrainState as JaxTrainState
from gator_tpu.train.loop import make_gator_train_step as jax_gator_step
from gator_tpu.train.loop import with_gt_synthesis as jax_with_gt_synthesis
from gator_tpu_torch import data as pdata
from gator_tpu_torch import losses
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.assets import smpl_assets as psmpl_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.data import device_pipeline as dp
from gator_tpu_torch.models import GATOR, GatorSpec
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
from gator_tpu_torch.train import Adam, TrainState, make_gator_train_step
from gator_tpu_torch.train.loop import with_gt_synthesis
from test_torch_convert import jax_variables
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import ZERO_GAT, _assert_grads, _capture_grads

N = 24
TOLS = {"pose2d": 1e-5, "mesh": 2e-6, "lift_pose3d": 2e-3,
        "reg_pose3d": 2e-3, "joint_cam": 2e-3}


def _gendered(jassets, passets):
    """Both packages' assets with distinct female and male models."""
    v = jassets.smpl_gendered["neutral"].vertex_num
    jg = dict(jassets.smpl_gendered, female=jsmpl_assets.synthetic_smpl(
        v, seed=11), male=jsmpl_assets.synthetic_smpl(v, seed=22))
    pg = dict(passets.smpl_gendered, female=psmpl_assets.synthetic_smpl(
        v, seed=11), male=psmpl_assets.synthetic_smpl(v, seed=22))
    return (dataclasses.replace(jassets, smpl_gendered=jg),
            dataclasses.replace(passets, smpl_gendered=pg))


@pytest.fixture(scope="module")
def pair(small_assets):
    """-> make(use_gt, gendered) = (JAX dataset, port dataset over the same
    table, JAX synthesizer, port synthesizer on the CPU)."""
    passets = build_assets("human36", data_dirs=[],
                           synthetic_vertex_num=890, seed=0)
    cache = {}

    def make(use_gt=True, gendered=False):
        if (use_gt, gendered) in cache:
            return cache[use_gt, gendered]
        ja, pa = (_gendered(small_assets, passets) if gendered
                  else (small_assets, passets))
        kw = dict(is_train=True, use_gt_input=use_gt, flip_enabled=True,
                  rotate_factor=30.0, input_joint_name="human36")
        jsyn = JaxSynth(ja)
        jds = JaxSynthetic(ja, jproc.ProcessOptions(**kw), n=N, seed=0,
                           synthesizer=jsyn)
        if gendered:
            jds.table.gender[:] = np.random.default_rng(9).integers(0, 3, N)
        table = pdata.SmplTable(**{
            f.name: getattr(jds.table, f.name)
            for f in dataclasses.fields(jds.table)})
        pds = pdata.SmplPoseDataset(pa, pdata.ProcessOptions(**kw), table)
        cache[use_gt, gendered] = (jds, pds, jsyn,
                                   pdata.GtSynthesizer(pa, "cpu"))
        return cache[use_gt, gendered]

    return make


def _spy(seen):
    def step(state, inner, *extra):
        seen.clear()
        seen.update(inner)
        return inner
    return step


def _check(got, want, keys=None):
    for k in keys or want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        if k.endswith("valid"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOLS[k],
                                       err_msg=k)


@pytest.mark.parametrize("j", [17, 19])
def test_augmentation_forms_match_jnp(j):
    rng = np.random.default_rng(j)
    b = 32
    img = rng.uniform(50, 400, (b, j, 2)).astype(np.float32)
    bad = img.copy()
    bad[0] = 100.0                       # a degenerate (bad) tight box
    flips = (rng.uniform(size=b) < 0.5).astype(np.float32)
    rots = rng.normal(0, 30, b).astype(np.float32)
    s = rng.normal(0, 300, (b, j, 3)).astype(np.float32)
    pairs = [(1, 4), (2, 5), (3, 6)] + ([(17, 18)] if j == 19 else [])
    perm = jdp._flip_perm(j, pairs)
    np.testing.assert_array_equal(dp._flip_perm(j, pairs), perm)
    shape = (384, 288)
    cases = {
        "affine_crop": (bad, shape, rots),
        "flip_standardize": (img / 3.0, perm, shape, flips),
        "crop_normalize_gt": (img, perm, shape, flips, rots),
        "j3d_augment": (s, perm, flips, rots),
    }
    for name, args in cases.items():
        # within 1e-6 of the largest value (bit-equal where the forms agree)
        want = np.asarray(getattr(jdp, name)(*(
            jnp.asarray(a) if isinstance(a, np.ndarray) and a is not perm
            else a for a in args)))
        got = getattr(dp, name)(*(
            torch.from_numpy(a) if isinstance(a, np.ndarray) and a is not perm
            else a for a in args)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()),
            err_msg=name)


@pytest.mark.parametrize("use_gt", [True, False])
@pytest.mark.parametrize("stage", ["gator", "gat"])
def test_raw_and_index_batches_equal(pair, use_gt, stage):
    jds, pds, _, _ = pair(use_gt)
    idx = np.arange(N)[::-2].copy()
    for form in ("make_raw_batch", "make_index_batch"):
        want = getattr(jds, form)(idx, np.random.default_rng(4), stage=stage)
        got = getattr(pds, form)(idx, np.random.default_rng(4), stage=stage)
        assert set(got) == set(want), form
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, (form, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pds.supports_raw_batches == jds.supports_raw_batches is True


def _jax_call(step, batch, *extra):
    return step(None, {k: jnp.asarray(v) for k, v in batch.items()},
                *extra)


def test_on_wrapper_assembles_jax_batch(pair):
    jds, pds, jsyn, psyn = pair(True)
    idx = np.arange(16)
    raw = pds.make_raw_batch(idx, np.random.default_rng(5))
    want, got = {}, {}
    _jax_call(jax_with_gt_synthesis(_spy(want), jsyn, 25.0), raw,
              jax.random.PRNGKey(0), jnp.asarray(1.0))
    step = with_gt_synthesis(_spy(got), psyn, 25.0)
    assert step(None, raw, 0, 1.0) is not None
    assert set(got) == set(want)
    _check(got, want)
    # the host path's batch at the same rows and draws
    full = pds.make_batch(idx, psyn, np.random.default_rng(5))
    _check(got, {k: np.asarray(v) for k, v in full.items()})


@pytest.mark.parametrize("gendered", [False, True])
def test_full_wrapper_assembles_jax_batch(pair, gendered):
    jds, pds, jsyn, psyn = pair(True, gendered)
    idx = np.arange(16)[::-1].copy()
    batch = pds.make_index_batch(idx, np.random.default_rng(6))
    want, got = {}, {}
    opts = jds.opts
    _jax_call(jdp.with_device_input_pipeline(
        _spy(want), jsyn, jds.table, jds.joint_set, opts,
        opts.fitting_thr), batch, jax.random.PRNGKey(0), jnp.asarray(1.0))
    step = dp.with_device_input_pipeline(
        _spy(got), psyn, pds.table, pds.joint_set, pds.opts,
        pds.opts.fitting_thr)
    step(None, batch, 0, 1.0)
    assert set(got) == set(want)
    _check(got, want)
    if gendered:
        assert len(set(pds.table.gender[idx])) == 3
    # the host path's batch at the same rows, flips and rotations
    full = pds.make_batch(idx, psyn, np.random.default_rng(6))
    _check(got, {k: torch.as_tensor(v).numpy() for k, v in full.items()})
    # the mesh cache gives the in-step targets
    cached = dp.with_device_input_pipeline(
        _spy({}), psyn, pds.table, pds.joint_set, pds.opts,
        pds.opts.fitting_thr, mesh_cache=True)
    again = cached.assemble(None, batch, 0, 1.0)
    for k in got:
        np.testing.assert_allclose(again[k].numpy(), got[k].numpy(), rtol=0,
                                   atol=1e-7 if k == "mesh" else 0,
                                   err_msg=k)


def test_full_gat_wrapper_assembles_jax_batch(pair):
    jds, pds, _, _ = pair(True)
    idx = np.arange(N)
    batch = pds.make_index_batch(idx, np.random.default_rng(7), stage="gat")
    want, got = {}, {}
    _jax_call(jdp.with_device_input_pipeline_gat(
        _spy(want), jds.table, jds.joint_set, jds.opts), batch,
        jax.random.PRNGKey(0))
    dp.with_device_input_pipeline_gat(
        _spy(got), pds.table, pds.joint_set, pds.opts, "cpu")(None, batch, 0)
    assert set(got) == set(want)
    _check(got, want)
    host = pds.make_batch(idx, None, np.random.default_rng(7), stage="gat")
    _check(got, host)


def test_detector_input_is_refused(pair):
    _, pds, _, psyn = pair(False)
    with pytest.raises(ValueError, match="use_gt_input"):
        dp.with_device_input_pipeline(_spy({}), psyn, pds.table,
                                      pds.joint_set, pds.opts, 25.0)


def test_full_step_matches_jax_fused_step(pair, small_assets):
    """One stage-2 step from an index batch through both packages' "full"
    wrappers around their fused steps: same weights, every rate 0, f32."""
    jds, pds, jsyn, psyn = pair(True)
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=64, depth=1,
                                     alpha=True, **ZERO_GAT)
    variables = jax_variables(init_gator, jspec, 0)
    tx = _capture_grads()
    jstep = jdp.with_device_input_pipeline(
        jax_gator_step(jspec, small_assets.faces,
                       small_assets.j_regressor_h36m, jlosses.LossWeights(),
                       tx, dtype=jnp.float32, fused=True,
                       fused_interpret=True,
                       fused_opts=dict(rates=JAX_ZERO, gat_mlp_rate=0.0)),
        jsyn, jds.table, jds.joint_set, jds.opts, jds.opts.fitting_thr)
    batch = pds.make_index_batch(np.arange(4), np.random.default_rng(8))
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)), tx)
    args = (jstep.const_args, jstate,
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jnp.asarray(1.0))
    # without XLA's backend optimisations: the compile dominates this test
    jstate2, jm = jax.jit(jstep.with_consts).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)

    model = GATOR(GatorSpec.from_assets(pds.assets, embed_dim=64, depth=1,
                                        alpha=True, **ZERO_GAT))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = TrainState(model, Adam(model.parameters(), lr=0.0))
    pstep = dp.with_device_input_pipeline(
        make_gator_train_step(model.spec, pds.assets.faces,
                              pds.assets.j_regressor_h36m,
                              losses.LossWeights(), rates=ZERO_RATES,
                              gat_mlp_rate=0.0),
        psyn, pds.table, pds.joint_set, pds.opts, pds.opts.fitting_thr)
    pm = pstep(state, batch, 0, 1.0)
    for key in ("loss", "vertex", "normal", "edge", "reg_joint",
                "lift_joint"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_grads({n: p.grad for n, p in model.named_parameters()},
                  state_dict_from_jax({"params": jax.tree_util.tree_map(
                      np.asarray, jstate2.opt_state)}))
