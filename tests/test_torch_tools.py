"""The port's counterparts of the JAX repo's root-level tools
(gator_tpu_torch/tools/: check_noise_distribution, exp_noise_ablate,
exp_train_ablate, profile_train --split, profile_gt_synth) on the CPU,
held to the JAX tools' own pieces on the same seeded inputs:
  * the noise gate: scalar and batch state frequencies equal to
    tools/check_noise_distribution.py's `run` (the two numpy simulators
    are bit-equal from one seed), the device form within the loosened bars
    of tests/test_data.py:291-292;
  * the noise ablation: `make_variant(f32, gumbel_pick=True)` is the
    shipped sampler bit for bit on the same draws; fed the JAX variant's
    own draws (its key schedule, in its dtype), each variant's band
    frequencies are within 0.02 of tools/exp_noise_ablate.py's same
    variant at B=4096;
  * the train ablation: every variant builds and takes one CPU step with
    a finite loss at small size; forward-only gives the full step's loss;
  * the split's and the GT-synthesis profile's parts equal their
    gator_tpu counterparts (1e-5).
A test that loads a JAX tool points JAX_CACHE_DIR at a tmp dir first (the
tools turn on XLA's persistent cache when imported) and restores the
cache settings after.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_device_noise import ANNULI, TableDraws
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)
from gator_tpu_torch.data import device_noise as dn
from gator_tpu_torch.tools import check_noise_distribution as cnd
from gator_tpu_torch.tools import exp_noise_ablate as ena

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKS = {0: 256, 2: 256, 4: 256, 9: 512, 10: 512}


def _load_jax_tool(name, tmp_path_factory):
    """tools/<name>.py loaded by path with XLA's cache in a tmp dir."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_CACHE_DIR", cache)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jax_noise_gate(tmp_path_factory):
    """The JAX gate with its device form (a jitted JAX sampler, which the
    comparison below does not read) replaced by zeros."""
    mod = _load_jax_tool("check_noise_distribution", tmp_path_factory)
    mod._device_form = lambda joints2, areas, seed: np.zeros_like(joints2)
    return mod


@pytest.fixture(scope="module")
def jax_noise_ablate(tmp_path_factory):
    return _load_jax_tool("exp_noise_ablate", tmp_path_factory)


# -- the noise gate ----------------------------------------------------------

def test_noise_gate_matches_the_jax_tool(jax_noise_gate):
    """run(n=600): the same keys per area, the same pose counts, and the
    scalar and batch forms' state frequencies equal to the JAX tool's."""
    got = cnd.run(n=600, seed=0, device="cpu")
    want = jax_noise_gate.run(n=600, seed=0)
    assert set(got) == set(want) == {"area_8000", "area_30000",
                                     "area_80000"}
    for area, w in want.items():
        g = got[area]
        assert set(g) == set(w), area
        assert g["n_poses"] == w["n_poses"] == 200
        for key in ("state_freq_scalar", "state_freq_batch",
                    "state_freq_max_abs_diff", "radius_ks_distance"):
            assert g[key] == w[key], (area, key)


def test_noise_gate_device_form_passes_the_loosened_bars():
    """The device form on the CPU from a seeded generator at n=3000, the
    size tests/test_data.py:291-292 loosened its bars for (frequencies
    within 0.02, KS within 0.04), against the host batch form (the
    scalar oracle's stand-in here: the JAX tool holds the two within 0.01
    at n=100,000; the tool on the card holds the device form to the oracle
    itself)."""
    n = 3000
    poses, areas = cnd.gate_poses(n, seed=0)
    host = cnd.noise.synthesize_pose_batch(
        np.concatenate([poses, np.ones((n, 17, 1), np.float32)], -1), areas,
        np.random.default_rng((0, 2)))
    host_xy = np.where(host[..., 2:] > 0, host[..., :2], 0.0)
    dev_xy = dn.synthesize_pose_device(
        torch.Generator().manual_seed(0), torch.from_numpy(poses),
        torch.from_numpy(areas)).numpy()
    diff, ks, _ = cnd.noise_gate(dev_xy, host_xy, poses, areas)
    assert diff <= 0.02 and ks <= 0.04, (diff, ks)


def test_noise_gate_main_writes_its_json_and_refuses_without_a_card(
        tmp_path):
    out = tmp_path / "gate.json"
    try:
        got = cnd.main(["--n", "90", "--device", "cpu", "--workers", "1",
                        "--out", str(out)])
    except SystemExit as e:     # the gate's bars at n = 300 may not hold
        assert e.code == 1
        got = None
    import json
    payload = json.loads(out.read_text())
    assert set(payload) >= {"n_total", "ks_bound", "passed", "areas"}
    assert payload["n_total"] == 90 and payload["card"] is None
    assert cnd.gate(payload["areas"], 90)[1] == pytest.approx(
        max(0.01, 3 * np.sqrt(2 / (30 * 17))))
    if got is not None:
        assert payload["passed"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cnd.main(["--n", "90"])


# -- the noise ablation ------------------------------------------------------

def test_gumbel_variant_is_the_shipped_sampler_bit_for_bit():
    joints, areas = ena.make_inputs(256, seed=1)
    jt, at = torch.from_numpy(joints), torch.from_numpy(areas)
    ship = dn.synthesize_pose_device(torch.Generator().manual_seed(4), jt, at)
    var = ena.make_variant(torch.float32, gumbel_pick=True)(
        torch.Generator().manual_seed(4), jt, at)
    assert torch.equal(ship, var)
    other = ena.make_variant(torch.float32, gumbel_pick=False)(
        torch.Generator().manual_seed(4), jt, at)
    assert not torch.equal(ship, other)


def _variant_schedule(key, b, dtype, gumbel):
    """Every uniform the JAX tool's `make_variant(dtype, gumbel)` draws, by
    the port's path, as f32 (a bf16 draw exactly): the annuli's angle and
    radius halves and a gumbel pick's uniforms in `dtype`, a cumsum pick's
    and the state draws in f32."""
    out = {}
    for w, wave in enumerate((dn._WAVE1, dn._WAVE2)):
        ks = jax.random.split(jax.random.fold_in(key, w), 12)
        m = len(wave)
        for i, k in ANNULI.items():
            ka, kr = jax.random.split(ks[i])
            out[(w, i, 0)] = jax.random.uniform(ka, (b, m, k), dtype)
            out[(w, i, 1)] = jax.random.uniform(kr, (b, m, k), dtype)
        for i, k in PICKS.items():
            out[(w, i)] = (jax.random.uniform(ks[i], (b, m, k), dtype)
                           if gumbel else jax.random.uniform(ks[i], (b, m)))
        for i in (8, 11):
            out[(w, i)] = jax.random.uniform(ks[i], (b, m))
    return {p: v.astype(jnp.float32) for p, v in out.items()}


@pytest.mark.parametrize("name,dtype,gumbel", [
    ("bf16", jnp.bfloat16, False), ("gumbel_pick", jnp.float32, True),
    ("bf16_gumbel", jnp.bfloat16, True)])
def test_noise_variants_band_frequencies_match_the_jax_tool(
        jax_noise_ablate, name, dtype, gumbel):
    """At B=4096 on the JAX tool's `make_inputs(4096, seed=3)`: the port's
    variant fed the JAX variant's draws against the JAX variant, band
    frequencies within 0.02 (the tool's bar)."""
    b = 4096
    joints, areas = ena.make_inputs(b, seed=3)
    jj, ja = jax_noise_ablate.make_inputs(b, seed=3)
    np.testing.assert_array_equal(np.asarray(jj), joints)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(jax_noise_ablate.make_variant(dtype, gumbel))(
        key, jj, ja))
    table = jax.jit(_variant_schedule, static_argnums=(1, 2, 3))(
        key, b, dtype, gumbel)
    got = ena.variants()[name](TableDraws(table), torch.from_numpy(joints),
                               torch.from_numpy(areas)).numpy()
    diff = np.abs(ena.band_freqs(got, joints, areas)
                  - jax_noise_ablate.band_freqs(want, joints, areas)).max()
    assert diff < 0.02, (name, diff)


def test_noise_ablation_main_on_the_cpu(tmp_path, monkeypatch):
    """Every variant and component at a small batch, the distribution
    check of the three variants (at B=64 here), the JSON's keys and
    `not_ported`."""
    import json
    out = tmp_path / "abl.json"
    monkeypatch.setattr(ena, "DIST_BATCH", 64)
    res = ena.main(["--device", "cpu", "--batches", "32", "--out",
                    str(out)])
    names = ("shipped_f32", "bf16", "gumbel_pick", "bf16_gumbel",
             "annulus_mask_only", "rng_draws_only")
    assert set(res["times_ms"]) == {f"{n}_b32" for n in names}
    assert all(t > 0 for t in res["times_ms"].values())
    assert set(res["dist_max_band_diff"]) == {"bf16", "gumbel_pick",
                                              "bf16_gumbel"}
    assert res["not_ported"] and res["card"] is None
    assert json.loads(out.read_text())["times_ms"] == res["times_ms"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ena.main(["--batches", "32"])


# -- the train ablation -------------------------------------------------------

def test_train_ablation_variants_step_on_the_cpu():
    """Every variant builds and takes CPU steps at small size (890
    vertices, depth 2, B=4) with a finite loss, under a caller's
    `no_grad` too (chip_smoke's); the sweep's fit, the derived block and
    `not_ported` (the JAX tool's three levers) are there."""
    from gator_tpu_torch.tools import exp_train_ablate as eta
    with torch.no_grad():
        res = eta.run(device="cpu", batches=(2, 4), batch=4,
                      vertex_num=890, depth=2, reps=1)
    assert set(res["variants"]) == set(eta.variants((2, 4), 4))
    for name, r in res["variants"].items():
        assert np.isfinite(r["loss"]) and r["host_ms"] > 0, name
        assert r["device_ms"] is None, name
    assert set(res["sweep"]["host_ms_by_batch"]) == {2, 4}
    assert set(res["derived"]) == {
        "fwd_share_ms", "vjp_share_ms", "save_activations_max_gain_ms",
        "save_activations_max_speedup"}
    text = " ".join(eta.NOT_PORTED)
    for lever in ("group_fwd", "group_bwd", "remat"):
        assert lever in text


def test_forward_only_gives_the_steps_loss():
    """`step.forward_loss` (the ablation's forward-only variant) on the
    same state, batch and seed gives the loss the full step reports."""
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.tools import exp_train_ablate as eta
    from gator_tpu_torch.train import Adam, TrainState, make_gator_train_step
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    spec = GatorSpec.from_assets(assets, depth=2)
    model = build_gator(spec, seed=3, device="cpu")
    state = TrainState(model, Adam(model.parameters(), lr=1e-4))
    step = make_gator_train_step(spec, assets.faces,
                                 assets.j_regressor_h36m,
                                 losses.LossWeights(), dtype=torch.bfloat16)
    batch = eta.make_batch(4, 17, spec.mdr.full_num)
    with torch.no_grad():
        fwd = float(step.forward_loss(state, batch, 9)[0].total)
    full = float(step(state, batch, 9)["loss"])
    assert fwd == full


# -- the split and the GT-synthesis profile -----------------------------------

def test_split_parts_run_and_the_losses_part_matches_jax(small_assets):
    from gator_tpu import losses as jlosses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.tools import profile_train as pt
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    model = build_gator(GatorSpec.from_assets(assets, depth=2), seed=0,
                        device="cpu")
    parts = pt.split_parts(model, assets, 4)
    assert len(parts) == 7
    for name, fn in parts.items():
        with torch.set_grad_enabled(not name.endswith("forward")):
            out = fn()
        assert torch.isfinite(out.float()).all(), name
    rng = np.random.default_rng(4)
    b, v = 3, small_assets.faces.max() + 1
    mesh = rng.normal(size=(b, v, 3)).astype(np.float32) * 0.1
    gt = rng.normal(size=(b, v, 3)).astype(np.float32) * 0.1
    lift = rng.normal(size=(b, 17, 3)).astype(np.float32) * 100
    reg = rng.normal(size=(b, 17, 3)).astype(np.float32) * 100
    j_reg = np.asarray(small_assets.j_regressor_h36m, np.float32)

    def jax_loss(m):
        pred = jnp.einsum("jv,bvc->bjc", j_reg, m * 1000.0,
                          precision=jax.lax.Precision.HIGHEST)
        ones = jnp.ones((b, v, 1))
        ones_j = jnp.ones((b, 17, 1))
        return jlosses.gator_loss(m, pred, lift, gt, reg, lift, ones,
                                  ones_j, ones_j, np.asarray(
                                      small_assets.faces),
                                  jlosses.LossWeights(), 1.0).total

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(mesh))
    tm = torch.tensor(mesh, requires_grad=True)
    got = pt.stage2_losses(tm, *(torch.from_numpy(a) for a in
                                 (gt, lift, reg, j_reg)), assets.faces)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tm.grad.numpy() / np.abs(want_g).max(),
                               np.asarray(want_g) / np.abs(want_g).max(),
                               atol=1e-5)


@pytest.fixture(scope="module")
def gt_parts():
    """profile_gt_synth's parts on a small synthetic SMPL dataset (890
    vertices, 16 rows, B=8 of them, flips and rotations on), their inputs
    as numpy, and the outputs."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.data import processing
    from gator_tpu_torch.data.gt_synth import GtSynthesizer
    from gator_tpu_torch.data.synthetic import SyntheticDataset
    from gator_tpu_torch.tools import profile_gt_synth as pgs
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                          seed=0)
    synth = GtSynthesizer(assets, "cpu")
    opts = processing.ProcessOptions(is_train=True, flip_enabled=True,
                                     rotate_factor=30.0)
    ds = SyntheticDataset(assets, opts, n=16, seed=0, synthesizer=synth)
    idx = {k: torch.as_tensor(v) for k, v in ds.make_index_batch(
        np.arange(8), np.random.default_rng(0)).items()}
    parts = pgs.parts({"synth": synth, "ds": ds, "idx_batch": idx,
                       "opts": opts})
    with torch.no_grad():
        outs = {name: fn() for name, fn in parts.items()}
    return {"synth": synth, "ds": ds, "idx": idx, "opts": opts,
            "outs": outs, "pgs": pgs}


def test_gt_synthesis_parts_match_jax(gt_parts, small_assets):
    from gator_tpu.data import device_pipeline as jdp
    from gator_tpu.data.gt_synth import GtSynthesizer as JaxSynth
    ds, idx, outs = gt_parts["ds"], gt_parts["idx"]["idx"].numpy(), \
        gt_parts["outs"]
    t = ds.table
    jsynth = JaxSynth(small_assets)
    mesh, _ = jsynth.smpl_mesh_cam(t.pose[idx], t.shape[idx], t.trans[idx],
                                   t.cam_r[idx], t.cam_t[idx], "neutral")
    got = outs["smpl_mesh_cam (full)"][0].numpy()
    np.testing.assert_allclose(got, np.asarray(mesh), rtol=1e-5, atol=1e-3)
    jc = t.joint_cam_h36m[idx]
    ones = np.ones((len(idx), got.shape[1], 3), np.float32)
    np.testing.assert_allclose(
        outs["fitting_error"].numpy(),
        np.asarray(jsynth.fitting_error(jc - jc[:, :1], ones)), rtol=1e-5)
    perm = jdp._flip_perm(ds.joint_set.joint_num, ds.joint_set.flip_pairs)
    flips = gt_parts["idx"]["flips"].numpy()
    rots = gt_parts["idx"]["rots"].numpy()
    p2 = jdp.crop_normalize_gt(jnp.asarray(t.joint_img_h36m[idx][..., :2]),
                               perm, gt_parts["opts"].input_shape, flips,
                               rots)
    j3 = jdp.j3d_augment(jnp.asarray(jc), perm, flips, rots)
    got_p2, got_j3 = outs["input assembly (crop + j3d)"]
    np.testing.assert_allclose(got_p2.numpy(), np.asarray(p2), atol=1e-5)
    np.testing.assert_allclose(got_j3.numpy(), np.asarray(j3), rtol=1e-5,
                               atol=1e-3)


def test_sequential_chain_equals_smpl_forward(gt_parts):
    """The comparison chain (one joint at a time) gives the joints of
    bodymodel/smpl.smpl_forward's level-batched chain (zero betas)."""
    from gator_tpu_torch.bodymodel.smpl import smpl_forward
    params = gt_parts["synth"].params["neutral"]
    pose = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.4, (6, 72)).astype(np.float32))
    rots, locs = gt_parts["pgs"].sequential_chain(params, pose)
    _, joints = smpl_forward(params, pose, torch.zeros(6, 10))
    np.testing.assert_allclose(locs.numpy(), joints.numpy(), atol=1e-5)
    assert rots.shape == (6, 24, 3, 3)
    eye = rots @ rots.transpose(-1, -2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(3), eye.shape), atol=1e-5)


def test_tools_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    from gator_tpu_torch.tools import (exp_train_ablate, profile_gt_synth,
                                       profile_train)
    for fn, argv in ((exp_train_ablate.main, []),
                     (profile_gt_synth.main, []),
                     (profile_train.main, ["--split", "gat"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            fn(argv)
    with pytest.raises(SystemExit, match="--split only"):
        profile_train.main(["--device", "cpu"])
