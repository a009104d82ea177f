"""The port's paths end to end on a card, through its entry points: the
serving call and the serve CLI, the training steps, the eval CLI and
`run_eval`, the real-dataset readers on fabricated trees, the in-step input
paths and detector noise on the device, the demo and the rest of the
surface, and data parallelism. A kernel path is held to the same call on
plain PyTorch (`use_kernels=False`), and the launch counters of the five
main-path kernels (K1 gat_trunk, K2 lbf_stack, K3 fused_attention, K4
lbf_stack_train, K5 gat_trunk_train) are read around it. Skips without a
card; the kernels alone are held in the other `*_cuda.py` files.

This file imports no JAX, so it runs on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_paths_cuda.py
Models at full width (synthetic 6890-vertex assets, 431 coarse vertices,
depth 6, embed 128, and 64 where the case says so), f32 with TF32 off.
Bars: meshes in f32 within 1e-4 m of the plain path, in bf16 within
5e-2 m of the plain f32 path; a kernel step against a plain step in f32
at zero rates: loss rel 1e-5, every parameter gradient scaled by its max
within 1e-4 (attention key biases, whose true gradient is zero, apart);
eval means within 1e-3 mm; the card's metric suite within rel 1e-5 of the
same suite on the CPU; the in-step batches at tests/test_packed.py's bars;
the data-parallel paths bit-equal where the arithmetic is the same and
otherwise at the bars of tests/test_torch_dp_step.py. Each planted fault
must break a bar.
"""
import copy
import functools
import os
import signal
import sys

import numpy as np
import pytest
import torch

from gator_tpu_torch import losses
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.config import load_config
from gator_tpu_torch.data import device_noise as dn
from gator_tpu_torch.models import GatorSpec, build_gator
from gator_tpu_torch.nn.gat_trunk_train import gat_trunk_train
from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES, lbf_stack_train
from gator_tpu_torch.serving import make_serving_fn
from gator_tpu_torch.train import (Adam, TrainState, make_gat_train_step,
                                   make_gator_train_step, run_eval)
from torch_fixtures import (grads, launched, noise_same_draws, only,
                            planted_cases, scaled, worst_grad,
                            write_fixtures)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, BF16 = torch.float32, torch.bfloat16
# (joint set, embed width): both joint sets at the published width, and
# K1's and K5's other instance
WIDTHS = {"human36": ("human36", 128), "coco": ("coco", 128),
          "human36_embed64": ("human36", 64)}
# the fabricated COCO pose of tests/test_coverage_extras.py:61-66, pixels
DEMO_POSE = np.array(
    [[500, 180], [520, 160], [480, 160], [545, 170], [455, 170],
     [580, 260], [420, 260], [610, 380], [390, 380], [630, 490],
     [370, 490], [560, 520], [440, 520], [565, 700], [435, 700],
     [570, 880], [430, 880]], np.float32)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fabricated trees at the writer's full size (Human36M train 1280
    and test 2048 rows with detections, 3DPW 512, COCO 1024, MuCo 1024)."""
    root = str(tmp_path_factory.mktemp("data"))
    write_fixtures(root)
    return root


@functools.lru_cache(maxsize=None)
def _assets(joint_set):
    return build_assets(joint_set, data_dirs=[], synthetic_vertex_num=6890,
                        seed=0)


def _model(joint_set, card, seed, **spec):
    """A full-width GATOR; coco takes the alpha head, human36 the
    BatchNorm head with seeded running stats."""
    alpha = joint_set == "coco"
    model = build_gator(GatorSpec.from_assets(_assets(joint_set),
                                              alpha=alpha, **spec),
                        seed=seed, device=card)
    if not alpha:
        gen = torch.Generator().manual_seed(seed)
        bn = model.pose2mesh.bias_norm
        bn.running_mean.copy_(torch.randn(bn.running_mean.shape,
                                          generator=gen) * 0.5)
        bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                        generator=gen) * 1.5 + 0.5)
    return model


TRAIN = ("gat_trunk_train_fwd", "gat_trunk_train_bwd",
         "lbf_stack_train_fwd", "lbf_stack_train_bwd")


def _err(a, b):
    return (torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs(
        ).max().item()


def _stage2(joint_set, model, dtype, lr, **kw):
    assets = _assets(joint_set)
    state = TrainState(model, Adam(model.parameters(), lr=lr))
    step = make_gator_train_step(
        model.spec, assets.faces, assets.j_regressor_h36m,
        losses.LossWeights(), dtype=dtype, **kw)
    return state, step


def _stage2_batch(model, b, seed, card):
    """One stage-2 batch of bench.py's shapes."""
    v, j = model.spec.mdr.full_num, model.spec.gat.num_joint
    rng = np.random.default_rng(seed)
    arrays = {"pose2d": rng.normal(size=(b, j, 2)),
              "mesh": rng.normal(size=(b, v, 3)) * 0.1,
              "lift_pose3d": rng.normal(size=(b, j, 3)) * 100,
              "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
              "mesh_valid": np.ones((b, v, 1)),
              "lift_valid": np.ones((b, j, 1)),
              "reg_valid": np.ones((b, 17, 1))}
    return {k: torch.from_numpy(a.astype(np.float32)).to(card)
            for k, a in arrays.items()}


# -- serving -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_serving_call_matches_the_plain_path(card, case):
    """`make_serving_fn` at B=256 on K1 and K2 against the same call on
    plain PyTorch: f32 within 1e-4 m, bf16 within 5e-2 m of the plain f32
    mesh; one K1 and six K2 launches a call and nothing else; a second
    bf16 call gives the same bits."""
    joint_set, width = WIDTHS[case]
    model = _model(joint_set, card, 1, embed_dim=width)
    gen = torch.Generator().manual_seed(5)
    pose = torch.randn(256, model.spec.gat.num_joint, 2,
                       generator=gen).to(card)
    ref, _ = make_serving_fn(model, F32, use_kernels=False)(pose)
    serve16 = make_serving_fn(model, BF16)
    with launched() as counts:
        mesh32, _ = make_serving_fn(model, F32)(pose)
        mesh16, _ = serve16(pose)
    only(counts, gat_trunk=2, lbf_stack=12)
    assert mesh32.shape == (256, 6890, 3)
    assert _err(mesh32, ref) <= 1e-4
    assert _err(mesh16, ref) <= 5e-2
    assert torch.equal(serve16(pose)[0], mesh16)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32_obj"])
def test_serve_cli(card, tmp_path, f32):
    """`gator_tpu_torch.cli.serve.main` on 300 seeded COCO poses (chunks of
    256, the last ragged): K1 and K2 launched and nothing else, meshes
    [300, 6890, 3] finite, in bf16 within 5e-2 m of the plain f32 path of
    the same seeded model; with --f32 --obj_dir --obj_every 100, within
    1e-4 m of `make_serving_fn` in f32 and one .obj every 100 poses."""
    from gator_tpu_torch.cli import serve as serve_cli
    from gator_tpu_torch.data import processing

    rng = np.random.default_rng(25 if f32 else 0)
    poses = np.concatenate([rng.uniform(50, 450, size=(300, 17, 2)),
                            rng.uniform(0.3, 1.0, size=(300, 17, 1))],
                           axis=2).astype(np.float32)
    src, dst = str(tmp_path / "poses.npy"), str(tmp_path / "m.npy")
    objs = str(tmp_path / "objs")
    np.save(src, poses)
    argv = ["--input_poses", src, "--joint_set", "coco", "--output", dst]
    argv += (["--obj_dir", objs, "--obj_every", "100", "--f32"] if f32
             else ["--batch_size", "256"])
    with launched() as counts:
        served = serve_cli.main(argv)
    only(counts, "gat_trunk", "lbf_stack")
    meshes = np.load(dst)
    assert meshes.shape == (300, 6890, 3) and np.isfinite(meshes).all()
    assert np.array_equal(served["meshes"], meshes)
    coco = build_assets("coco")
    model = build_gator(GatorSpec.from_assets(coco), seed=0, device=card)
    pose2d = torch.from_numpy(processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses, list(coco.joint_set.joints_name))[..., :2],
        coco.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name="coco"),
        np.zeros(300, np.int64), np.zeros(300, np.float32))).to(card)
    if f32:
        fn = make_serving_fn(model, F32)
        ref = torch.cat([fn(pose2d[lo:lo + 256])[0] for lo in (0, 256)])
        assert sorted(os.listdir(objs)) == [
            f"mesh_{i:06d}.obj" for i in (0, 100, 200)]
    else:
        ref, _ = make_serving_fn(model, F32, use_kernels=False)(pose2d)
    assert _err(meshes, ref.cpu()) <= (1e-4 if f32 else 5e-2)


# -- training ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_stage2_kernel_step_matches_the_plain_step(card, case):
    """One stage-2 step on K4 and K5 against the plain step, f32, zero
    rates, B=16: the loss within rel 1e-5, every parameter gradient scaled
    by its max within 1e-4."""
    joint_set, width = WIDTHS[case]
    zero = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
    kernel = _model(joint_set, card, 5, embed_dim=width, **zero)
    plain = copy.deepcopy(kernel)
    batch = _stage2_batch(kernel, 16, 2, card)
    loss = {}
    for name, m, use in (("kernel", kernel, True), ("plain", plain, False)):
        state, step = _stage2(joint_set, m, F32, 0.0, use_kernels=use,
                              rates=ZERO_RATES, gat_mlp_rate=0.0)
        with torch.enable_grad():
            loss[name] = float(step(state, batch, 0, 1.0)["loss"])
    assert abs(loss["kernel"] - loss["plain"]) <= 1e-5 * abs(loss["plain"])
    worst, which = worst_grad(grads(kernel), grads(plain))
    assert worst <= 1e-4, (which, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_stage2_steps_on_the_kernels_fall(card, case):
    """The main training path: 20 stage-2 steps at B=512 bf16, default
    rates, on one fixed batch: the losses finite and falling; K5 and K4
    launched forward and backward, and nothing else."""
    joint_set, width = WIDTHS[case]
    model = _model(joint_set, card, 11, embed_dim=width)
    state, step = _stage2(joint_set, model, BF16, 1e-3)
    batch = _stage2_batch(model, 512, 1, card)
    with launched() as counts, torch.enable_grad():
        curve = [float(step(state, batch, 7, 1.0)["loss"])
                 for _ in range(20)]
    assert np.isfinite(curve).all() and curve[-1] < curve[0], curve
    only(counts, *TRAIN)


@pytest.mark.cuda
def test_stage1_steps_on_the_kernels_fall(card):
    """10 stage-1 steps of the full-width GAT lifter at B=256 bf16: the
    losses finite and falling, K5 launched forward and backward and
    nothing else."""
    gat = _model("human36", card, 12).pose_lifter
    rng = np.random.default_rng(3)
    batch = {"pose2d": rng.normal(size=(256, 17, 2)),
             "joint_cam": rng.normal(0, 100, size=(256, 17, 3)),
             "joint_valid": np.ones((256, 17, 1))}
    batch = {k: torch.from_numpy(a.astype(np.float32)).to(card)
             for k, a in batch.items()}
    state = TrainState(gat, Adam(gat.parameters(), lr=8e-4))
    step = make_gat_train_step(gat.spec, dtype=BF16)
    with launched() as counts, torch.enable_grad():
        curve = [float(step(state, batch, 3)["loss"]) for _ in range(10)]
    assert np.isfinite(curve).all() and curve[-1] < curve[0], curve
    only(counts, *TRAIN[:2])


# -- evaluation --------------------------------------------------------------

@pytest.mark.cuda
def test_eval_paths_launch_k3_and_match_plain_attention(card, tmp_path):
    """`cli.test.main` on configs/gator_synthetic_e2e.yml --synthetic
    (human36), the same session with coco input and alpha, the GAT config
    (no kernel), then `Session` + `run_eval` over 2048 samples at B=512:
    the errors finite, K3 launched 3 times a GATOR batch and nothing else;
    against the same run on plain attention every predicted mesh within
    1e-4 m, MPJPE and MPVPE within 1e-3 mm."""
    from gator_tpu_torch.cli import test as test_cli
    from gator_tpu_torch.cli.common import Session

    e2e = os.path.join(ROOT, "configs", "gator_synthetic_e2e.yml")
    gat_cfg = os.path.join(ROOT, "configs", "gat_synthetic_e2e.yml")
    vis = str(tmp_path)
    with launched() as counts:
        res = test_cli.main(["--cfg", e2e, "--synthetic", "--vis_dir", vis])
        coco_cfg = load_config(e2e, overrides={
            "DATASET": {"input_joint_set": "coco"}, "MODEL": {"alpha": True}})
        res_c, full_c = test_cli.run_test(coco_cfg, synthetic=True,
                                          vis_dir=vis)
        res_g = test_cli.main(["--cfg", gat_cfg, "--synthetic", "--vis_dir",
                               vis])
    assert np.isfinite([res["mpjpe"], res_c["mpjpe"], full_c["surface_err"],
                        res_g["mpjpe"]]).all()
    # 256 synthetic samples at the config's test batch of 512: one batch
    # for each GATOR run
    only(counts, fused_attention=3 * 2)

    sess = Session(load_config(e2e), synthetic=True, synthetic_n=2048)
    model = sess.build_model()
    with launched() as counts:
        kern = run_eval(sess.make_eval_step(), model, sess.pipeline,
                        collect_out=("pred_mesh_mm",))
    assert len(sess.pipeline) == 4 and kern["count"] == 2048
    only(counts, fused_attention=3 * 4)
    plain = run_eval(sess.make_eval_step(use_kernels=False), model,
                     sess.pipeline, collect_out=("pred_mesh_mm",))
    assert np.isfinite(kern["pred_mesh_mm"]).all()
    assert np.abs(kern["pred_mesh_mm"]
                  - plain["pred_mesh_mm"]).max() / 1000.0 <= 1e-4
    for key in ("joint_err", "surface_err"):
        assert abs(kern[key] - plain[key]) <= 1e-3, key


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "gator_human36J_test_human36_det.yml",
    "gator_cocoJ_test_human36_coco_muco_gt.yml"])
def test_run_test_on_the_fabricated_trees(card, trees, tmp_path, monkeypatch,
                                          name):
    """`cli.test.run_test` with a saved seeded checkpoint on a real-dataset
    test config read through $GATOR_DATA_DIR (Human36M with detector input,
    its protocol-2 suite; 3DPW's suite): every row evaluated, K3 launched 3
    times a batch and nothing else, the suite's four metrics finite and
    within rel 1e-5 of the same suite on the CPU, the GT mesh as
    prediction reading MPVPE 0."""
    from gator_tpu_torch.cli import test as test_cli
    from gator_tpu_torch.cli.common import build_datasets
    from gator_tpu_torch.train import save_checkpoint

    monkeypatch.setenv("GATOR_DATA_DIR", trees)
    cfg = load_config(os.path.join(ROOT, "configs", name))
    assets = _assets(cfg.DATASET.input_joint_set)
    model = build_gator(GatorSpec.from_assets(
        assets, embed_dim=cfg.MODEL.embed_dim, depth=cfg.MODEL.depth,
        alpha=cfg.MODEL.alpha), seed=21, device="cpu")
    weights = save_checkpoint(str(tmp_path / "w"), model, 1)
    with launched() as counts:
        suite, res = test_cli.run_test(cfg, weights,
                                       vis_dir=str(tmp_path / "vis"),
                                       assets=assets)
    (ds,) = build_datasets(cfg, assets, cfg.DATASET.test_list, False)
    n = len(ds)
    assert res["count"] == n
    only(counts, fused_attention=3 * -(-n // cfg.TEST.batch_size))
    keys = {"mpjpe", "pa_mpjpe", "smpl_mpjpe", "mpvpe"}
    assert set(suite) == keys and np.isfinite(list(suite.values())).all()
    pred = torch.as_tensor(res["pred_mesh_mm"][:n])
    gt = torch.as_tensor(res["mesh"][:n]) * 1000.0
    host = ds.evaluate(pred, gt, verbose=False)
    for k in keys:
        assert abs(host[k] - suite[k]) <= 1e-5 * abs(host[k]), k
    zero = ds.evaluate(gt.to(card), gt.to(card), verbose=False)
    assert zero["mpvpe"] == 0.0 and zero["smpl_mpjpe"] == 0.0, zero


# -- the flagship mix and the in-step input paths ----------------------------

@pytest.mark.cuda
def test_flagship_steps_from_the_host_pipeline(card, trees, monkeypatch):
    """configs/gator_synthetic_flagship.yml's mix (Human36M + COCO + MuCo
    readers, COCO joints, detector input, augmentation) through
    `data.BatchPipeline`: batches of the configured shape, finite; 5
    stage-2 steps at B=512 bf16 fed by the pipeline, losses finite, K4
    and K5 launched and nothing else."""
    from gator_tpu_torch.cli.common import build_datasets
    from gator_tpu_torch.data import BatchPipeline, GtSynthesizer

    monkeypatch.setenv("GATOR_DATA_DIR", trees)
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_flagship.yml"))
    coco = _assets("coco")
    synth = GtSynthesizer(coco, card)
    datasets = build_datasets(cfg, coco, cfg.DATASET.train_list, True,
                              synthesizer=synth)
    assert [type(d).__name__ for d in datasets] == [
        "Human36M", "CocoDataset", "MucoDataset"]
    assert not datasets[0].opts.use_gt_input
    b = cfg.TRAIN.batch_size
    pipe = BatchPipeline(datasets, synth, b, shuffle=cfg.TRAIN.shuffle,
                         seed=cfg.seed)
    spec = GatorSpec.from_assets(coco, embed_dim=cfg.MODEL.embed_dim,
                                 depth=cfg.MODEL.depth, alpha=cfg.MODEL.alpha)
    model = build_gator(spec, seed=23, device=card)
    state = TrainState(model, Adam(model.parameters(), lr=cfg.TRAIN.lr))
    step = make_gator_train_step(
        spec, coco.faces, coco.j_regressor_h36m,
        losses.LossWeights(normal=cfg.MODEL.normal_loss_weight,
                           edge=cfg.MODEL.edge_loss_weight,
                           joint=cfg.MODEL.joint_loss_weight),
        dtype=BF16)
    edge = float(cfg.TRAIN.begin_epoch >= cfg.TRAIN.edge_loss_start)
    pipe.set_epoch(1)
    it = iter(pipe)
    curve = []
    with launched() as counts, torch.enable_grad():
        for _ in range(5):
            batch = next(it)
            assert batch["pose2d"].shape == (b, 19, 2)
            assert batch["mesh"].shape == (b, coco.mean_vertices.shape[0], 3)
            assert np.isfinite(batch["pose2d"]).all()
            curve.append(float(step(state, batch, cfg.seed, edge)["loss"]))
    del it
    assert np.isfinite(curve).all(), curve
    only(counts, *TRAIN)


class _Recorded(dn.Draws):
    """Draws from a CPU generator, each kept by its path."""

    def __init__(self, seed):
        self.gen, self.table = torch.Generator().manual_seed(seed), {}

    def uniform(self, path, shape):
        self.table[path] = torch.rand(tuple(shape), generator=self.gen)
        return self.table[path]

    def normal(self, path, shape):
        self.table[path] = torch.randn(tuple(shape), generator=self.gen)
        return self.table[path]


class _Replay(dn.Draws):
    """The recorded draws again, on the card."""

    def __init__(self, table, card):
        self.table = {k: v.to(card) for k, v in table.items()}

    def uniform(self, path, shape):
        return self.table[path]

    normal = uniform


@pytest.mark.cuda
def test_device_noise_on_the_cpus_draws_is_its_cpu_form(card):
    """`synthesize_pose_device` at B=512 on the card, fed uniforms drawn on
    the CPU: the CPU form's output within 1e-3 px on every (row, joint)
    but at most 0.2 % boundary cases, each shown to be one
    (`noise_same_draws`); `h36m_syn_error_device` within 1e-6."""
    from gator_tpu_torch.data import noise
    from gator_tpu_torch.tools.check_noise_distribution import gate_poses
    from torch_fixtures import H36M_JOINTS

    poses, areas = gate_poses(512, seed=26)
    rec = _Recorded(26)
    want = dn.synthesize_pose_device(rec, torch.from_numpy(poses),
                                     torch.from_numpy(areas)).numpy()
    got = dn.synthesize_pose_device(
        _Replay(rec.table, card), torch.from_numpy(poses).to(card),
        torch.from_numpy(areas).to(card)).cpu().numpy()
    noise_same_draws(poses, areas,
                     {k: v.numpy() for k, v in rec.table.items()}, got, want)
    stats = torch.from_numpy(noise.h36m_error_stats(H36M_JOINTS))
    rec = _Recorded(27)
    want = dn.h36m_syn_error_device(rec, stats, 512, (384, 288)).numpy()
    got = dn.h36m_syn_error_device(_Replay(rec.table, card), stats.to(card),
                                   512, (384, 288)).cpu().numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.cuda
def test_device_noise_on_the_cards_generator_passes_the_gate(card):
    """With the card's own generator, 4096 poses over the recipe's three
    OKS areas against the host `synthesize_pose_batch`: every state
    frequency within 0.01, the KS distance of the error radii within
    max(0.01, 3 sqrt(2 / (17 N))) (tools/check_noise_distribution.py's
    gate)."""
    from gator_tpu_torch.data import noise
    from gator_tpu_torch.tools.check_noise_distribution import (gate_poses,
                                                                noise_gate)

    n = 4096
    poses, areas = gate_poses(n, seed=0)
    host = noise.synthesize_pose_batch(
        np.concatenate([poses, np.ones((n, 17, 1), np.float32)], -1),
        areas, np.random.default_rng((0, 2)))
    host_xy = np.where(host[..., 2:] > 0, host[..., :2], 0.0)
    card_xy = dn.synthesize_pose_device(
        torch.Generator(device=card).manual_seed(0),
        torch.from_numpy(poses).to(card),
        torch.from_numpy(areas).to(card)).cpu().numpy()
    diff, ks, ks_bar = noise_gate(card_xy, host_xy, poses, areas)
    assert diff <= 0.01 and ks <= ks_bar, (diff, ks, ks_bar)


@pytest.mark.cuda
def test_flagship_device_mode_steps(card, trees, monkeypatch):
    """`Session(cfg, is_train=True)` on the flagship config over the
    fabricated trees: "auto" resolves to "device", index batches on the
    card, no device-to-host sync in the step's input assembly
    (`set_sync_debug_mode("error")`), the assembled input finite and of
    its shape; 5 stage-2 steps at B=512 bf16 fed by the pipeline, losses
    finite, K4 and K5 launched and nothing else."""
    from gator_tpu_torch.cli.common import Session

    monkeypatch.setenv("GATOR_DATA_DIR", trees)
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_flagship.yml"))
    sess = Session(cfg, device=card, is_train=True)
    assert sess.gt_in_step == "device"
    assert [type(d).__name__ for d in sess.datasets] == [
        "Human36M", "CocoDataset", "MucoDataset"]
    state, step = sess.make_train_step(lambda p: Adam(p, lr=cfg.TRAIN.lr))
    edge = float(cfg.TRAIN.begin_epoch >= cfg.TRAIN.edge_loss_start)
    it = iter(sess.pipeline)
    first = next(it)
    it.close()
    assert set(first) == {"row", "flips", "rots"}
    assert all(v.device.type == "cuda" for v in first.values())
    with torch.enable_grad():
        step(state, first, cfg.seed, edge)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inner = step.assemble(state, first, cfg.seed, edge)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert inner["pose2d"].shape == (cfg.TRAIN.batch_size, 19, 2)
    assert bool(torch.isfinite(inner["pose2d"]).all())
    sess.pipeline.set_epoch(1)
    it = iter(sess.pipeline)
    with launched() as counts, torch.enable_grad():
        curve = [float(step(state, next(it), cfg.seed, edge)["loss"])
                 for _ in range(5)]
    it.close()
    assert np.isfinite(curve).all(), curve
    only(counts, *TRAIN)


IN_STEP = {"gator_full": ("gator_synthetic_e2e.yml", "full"),
           "gat_full": ("gat_synthetic_e2e.yml", "full"),
           "gator_on": ("gator_synthetic_e2e.yml", "on")}
IN_STEP_BARS = {"pose2d": 1e-5, "mesh": 2e-6, "lift_pose3d": 2e-3,
                "reg_pose3d": 2e-3, "joint_cam": 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(IN_STEP))
def test_in_step_batch_is_the_host_paths(card, case):
    """The e2e configs with augmentation on, in "full" mode (both stages)
    and in "on" mode: the wrapped step's batch against the host path's at
    the same rows, flips and rotations (pose2d 1e-5, mesh 2e-6 m, joints
    2e-3 mm, masks equal); 3 steps, losses finite, K5 (and for GATOR K4)
    launched and nothing else."""
    from gator_tpu_torch.cli.common import Session

    name, mode = IN_STEP[case]
    over = {"AUG": {"flip": True, "rotate_factor": 30}}
    if mode == "on":
        over["TRAIN"] = {"gt_in_step": "on"}
    cfg = load_config(os.path.join(ROOT, "configs", name), over)
    sess = Session(cfg, synthetic=True, synthetic_n=4 * cfg.TRAIN.batch_size,
                   device=card, is_train=True)
    assert sess.gt_in_step == mode
    state, step = sess.make_train_step(lambda p: Adam(p, lr=cfg.TRAIN.lr))
    extra = (cfg.seed, 1.0) if sess.is_gator else (cfg.seed,)
    stage = "gator" if sess.is_gator else "gat"
    ds = sess.datasets[0]
    idx = np.arange(cfg.TRAIN.batch_size)[::-1].copy()
    form = ds.make_raw_batch if mode == "on" else ds.make_index_batch
    batch = form(idx, np.random.default_rng(27), stage=stage)
    if mode != "on":
        batch = {k: torch.as_tensor(v, device=card) for k, v in batch.items()}
    got = step.assemble(state, batch, *extra)
    host = ds.make_batch(idx, sess.synth, np.random.default_rng(27),
                         stage=stage)
    assert set(got) == set(host)
    for k, v in host.items():
        g = got[k].float().cpu().numpy()
        h = torch.as_tensor(v).float().cpu().numpy()
        assert g.shape == h.shape, k
        bar = 0.0 if k.endswith("valid") else IN_STEP_BARS[k]
        assert np.abs(g - h).max() <= bar, k
    it = iter(sess.pipeline)
    with launched() as counts, torch.enable_grad():
        curve = [float(step(state, next(it), *extra)["loss"])
                 for _ in range(3)]
    it.close()
    assert np.isfinite(curve).all(), curve
    only(counts, *(TRAIN if sess.is_gator else TRAIN[:2]))


@pytest.mark.cuda
def test_train_cli_resumes_after_sigterm(card, tmp_path, monkeypatch):
    """`cli.train.run_train` on configs/gator_synthetic_smoke.yml at full
    width (B=16 f32, two epochs): a SIGTERM in epoch 2 writes checkpoint1
    alone, and --resume_training ends with epoch 2's loss, MPJPE and MPVPE
    within rel 1e-4 of an uninterrupted run's."""
    from gator_tpu_torch.cli.train import run_train
    from gator_tpu_torch.data.pipeline import BatchPipeline
    from gator_tpu_torch.train import load_checkpoint

    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_smoke.yml"))
    straight, run = str(tmp_path / "straight"), str(tmp_path / "run")
    set_epoch = BatchPipeline.set_epoch

    def term_in_epoch_2(self, epoch):
        set_epoch(self, epoch)
        if epoch == 2 and self.drop_last:       # the training pipeline
            signal.raise_signal(signal.SIGTERM)

    with torch.enable_grad():
        run_train(cfg, exp_dir=straight, synthetic=True)
        with monkeypatch.context() as mp:
            mp.setattr(BatchPipeline, "set_epoch", term_in_epoch_2)
            run_train(cfg, exp_dir=run, synthetic=True)
        assert sorted(os.listdir(os.path.join(run, "checkpoint"))) == [
            "best.pth.tar", "checkpoint1.pth.tar"]
        run_train(cfg, exp_dir=run, synthetic=True, resume=True)
    got, want = (load_checkpoint(os.path.join(d, "checkpoint",
                                              "final.pth.tar"))
                 for d in (run, straight))
    pairs = [(got["train_log"][1], want["train_log"][1])] + [
        (got["test_log"][k][1], want["test_log"][k][1])
        for k in ("joint", "surface")]
    for a, b in pairs:
        assert abs(a - b) <= 1e-4 * abs(b), pairs


# -- the demo and the rest of the surface ------------------------------------

DEMO_RUNS = {"coco": ("coco", []), "coco_adam_fit": ("coco", ["--adam_fit"]),
             "human36": ("human36", [])}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DEMO_RUNS))
def test_demo_main(card, tmp_path, monkeypatch, capsys, case):
    """`cli.demo.main` with seeded weights on the fabricated COCO pose,
    cv2 hidden: K3 launched 3 times and nothing else, demo_mesh.obj with
    6890 finite vertices, the two PNGs skipped and named, the fitted
    camera and L1 finite; the mesh within 1e-4 m of the same model's
    plain path on the same input, a closed-form camera within rel 1e-4 of
    the same fit on the CPU."""
    from gator_tpu_torch.cli import demo

    joint_set, flags = DEMO_RUNS[case]
    monkeypatch.setitem(sys.modules, "cv2", None)
    pose_path = str(tmp_path / "pose.npy")
    np.save(pose_path, np.concatenate(
        [DEMO_POSE + np.random.default_rng(1234).normal(
            0, 5, (17, 2)).astype(np.float32),
         np.ones((17, 1), np.float32)], 1))
    weights = str(tmp_path / "w.pth.tar")
    torch.save({"epoch": 0, "model_state_dict": build_gator(
        GatorSpec.from_assets(build_assets(joint_set)), seed=1,
        device="cpu").state_dict()}, weights)
    kept = {}
    real_build, real_fit = demo.build_gator, demo.fit_camera_closed_form

    def keep_input(module, args):
        kept.setdefault("pose2d", args[0])

    def keep_model(*a, **k):
        kept["model"] = real_build(*a, **k)
        kept["model"].register_forward_pre_hook(keep_input)
        return kept["model"]

    def keep_fit(pose3d, target, crop):
        kept["fit"] = (pose3d, target, crop)
        return real_fit(pose3d, target, crop)

    monkeypatch.setattr(demo, "build_gator", keep_model)
    monkeypatch.setattr(demo, "fit_camera_closed_form", keep_fit)
    out_dir = str(tmp_path / "out")
    capsys.readouterr()
    with launched() as counts:
        res = demo.main(["--input_pose", pose_path, "--joint_set",
                         joint_set, "--weights", weights, "--output_dir",
                         out_dir] + flags)
    lines = capsys.readouterr().out.splitlines()
    only(counts, fused_attention=3)
    with open(res["obj_path"]) as f:
        obj_v = np.array([ln.split()[1:] for ln in f if ln.startswith("v ")],
                         np.float64)
    assert obj_v.shape == (6890, 3) and np.isfinite(obj_v).all()
    assert res["mesh"].shape == (6890, 3) and np.isfinite(res["mesh"]).all()
    assert not any(os.path.exists(os.path.join(out_dir, name))
                   for name in demo.IMAGES)
    assert any(line.startswith("skipped demo_mesh.png and demo_pose2d.png: "
                               "cv2 is not installed") for line in lines)
    cam = np.concatenate([res["cam"].s.cpu().numpy()[0],
                          res["cam"].t.cpu().numpy()[0]])
    assert np.isfinite(cam).all()
    assert np.isfinite(float(lines[0].split("L1=")[1][:-2]))
    with torch.no_grad():
        plain, _ = kept["model"](kept["pose2d"], use_kernels=False)
    assert _err(res["mesh"], plain[0].cpu()) <= 1e-4
    if "fit" in kept:
        pose3d, target, crop = kept["fit"]
        cpu = real_fit(pose3d.cpu(), target.cpu(), crop)
        cpu_cam = np.concatenate([cpu.s.numpy()[0], cpu.t.numpy()[0]])
        assert np.abs(cam - cpu_cam).max() <= 1e-4 * np.abs(cpu_cam).max()


@pytest.mark.cuda
def test_surface_on_the_card_matches_the_cpu(card):
    """MeshResampler down and up, GraphResBlock (64->128, 128->128),
    mano_forward on synthetic_mano(0), rot6d_to_rotmat and
    one_euro_smooth_torch on the card within 1e-5 of the CPU, f32."""
    from gator_tpu_torch import ops
    from gator_tpu_torch.assets import skeletons
    from gator_tpu_torch.bodymodel import mano, rotations6d
    from gator_tpu_torch.smoothing import one_euro_smooth_torch

    gen = torch.Generator().manual_seed(29)
    sampling = _assets("human36").sampling
    res_cpu = ops.MeshResampler(sampling)
    res_card = ops.MeshResampler(sampling).to(card)
    xv = torch.randn(8, sampling.down1.shape[1], 3, generator=gen)
    xc = torch.randn(8, sampling.down2.shape[0], 3, generator=gen)
    errs = {"MeshResampler down": _err(
                res_card.downsample(xv.to(card), 0, 2).cpu(),
                res_cpu.downsample(xv, 0, 2)),
            "MeshResampler up": _err(
                res_card.upsample(xc.to(card), 2, 0).cpu(),
                res_cpu.upsample(xc, 2, 0))}
    adj = ops.row_normalized_adjacency(
        skeletons.gat_adjacency(skeletons.COCO), 2)
    for cin, cout in ((64, 128), (128, 128)):
        block = ops.GraphResBlock(cin, cout, adj)
        xb = torch.randn(64, 19, cin, generator=gen)
        with torch.no_grad():
            errs[f"GraphResBlock {cin}->{cout}"] = _err(
                block.to(card)(xb.to(card)).cpu(), block.cpu()(xb))
    hand = mano.synthetic_mano(0)
    params = {str(p): mano.ManoParams.from_model(hand, device=p)
              for p in ("cpu", card)}
    pose = torch.randn(64, 48, generator=gen) * 0.5
    betas = torch.randn(64, 10, generator=gen)
    errs["mano_forward"] = max(_err(a.cpu(), c) for a, c in zip(
        mano.mano_forward(params[str(card)], pose.to(card), betas.to(card)),
        mano.mano_forward(params["cpu"], pose, betas)))
    rot6d = torch.randn(4096, 6, generator=gen)
    errs["rot6d_to_rotmat"] = _err(
        rotations6d.rot6d_to_rotmat(rot6d.to(card)).cpu(),
        rotations6d.rot6d_to_rotmat(rot6d))
    track = torch.randn(64, 17, 3, generator=gen).cumsum(0)
    errs["one_euro_smooth_torch"] = _err(
        one_euro_smooth_torch(track.to(card)).cpu(),
        one_euro_smooth_torch(track))
    assert all(e <= 1e-5 for e in errs.values()), errs


@pytest.mark.cuda
def test_trace_and_memory_stats_on_the_card(card, tmp_path):
    """`profiling.trace` around one forward of the module form (the
    demo's) writes a trace; `device_memory_stats` names every card."""
    from gator_tpu_torch import profiling

    model = _model("coco", card, 1)
    pose = torch.zeros(1, model.spec.gat.num_joint, 2, device=card)
    with profiling.trace(str(tmp_path)), torch.no_grad():
        model(pose)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    assert torch.cuda.get_device_name(0) in next(iter(stats))


# -- data parallelism --------------------------------------------------------

@pytest.fixture(scope="module")
def dp(card):
    """The data-parallel cases' model (full-width human36, the BatchNorm
    head with seeded running stats) and data: a stage-2 batch of 512 with
    some meshes invalid, eval batches of 300 and a ragged 77, 256 poses."""
    assets = _assets("human36")
    model = _model("human36", card, 21)
    v = model.spec.mdr.full_num
    rng = np.random.default_rng(30)
    batch = {"pose2d": rng.normal(size=(512, 17, 2)),
             "mesh": rng.normal(size=(512, v, 3)) * 0.1,
             "lift_pose3d": rng.normal(size=(512, 17, 3)) * 100,
             "reg_pose3d": rng.normal(size=(512, 17, 3)) * 100,
             "mesh_valid": rng.uniform(size=(512, 1, 1)) < 0.8,
             "lift_valid": np.ones((512, 17, 1)),
             "reg_valid": np.ones((512, 17, 1))}
    batch = {k: a.astype(np.float32) for k, a in batch.items()}
    evals = [{"pose2d": rng.normal(size=(n, 17, 2)).astype(np.float32),
              "mesh": (rng.normal(size=(n, v, 3)) * 0.1).astype(np.float32),
              "reg_pose3d": (rng.normal(size=(n, 17, 3)) * 100).astype(
                  np.float32)} for n in (300, 77)]
    poses = rng.normal(size=(256, 17, 2)).astype(np.float32)
    return {"assets": assets, "model": model, "batch": batch,
            "evals": evals, "poses": poses,
            "state_dict": {k: t.cpu().numpy()
                           for k, t in model.state_dict().items()}}


@pytest.mark.cuda
def test_world_1_over_nccl_is_the_one_device_path(card, dp, tmp_path):
    """World 1 over NCCL in this process: the stage-2 step at B=512 bf16
    with the default rates, `run_eval` over 377 samples and the sharded
    serving call at B=256 bf16 give the one-device path's bits (loss,
    every gradient, every parameter and running stat after the step, the
    eval means, count and collected rows, the served meshes), with K1-K5
    launched."""
    from gator_tpu_torch.parallel import close_world, join_world
    from gator_tpu_torch.serving import make_sharded_serving_fn
    from gator_tpu_torch.train import make_gator_eval_step

    assets, model = dp["assets"], dp["model"]
    batch = {k: torch.from_numpy(a).to(card) for k, a in dp["batch"].items()}
    poses = torch.from_numpy(dp["poses"]).to(card)
    estep = make_gator_eval_step(assets.j_regressor_h36m,
                                 assets.joint_set.eval_joints)
    runs = {}
    world = join_world(0, 1, card, "nccl", f"file://{tmp_path}/rendezvous",
                       timeout_s=120)
    try:
        for name, w in (("one device", None), ("world 1", world)):
            with launched() as counts:
                m = copy.deepcopy(model)
                state, step = _stage2("human36", m, BF16, 1e-4, world=w)
                with torch.enable_grad():
                    loss = float(step(state, batch, 7, 1.0)["loss"])
                ev = run_eval(estep, model, dp["evals"],
                              collect_out=("pred_mesh_mm",),
                              collect_batch=("mesh",), world=w)
                fn = (make_serving_fn(model, BF16) if w is None
                      else make_sharded_serving_fn(model, w, BF16))
                served = fn(poses)
            runs[name] = {"loss": loss, "grads": grads(m),
                          "state": {k: t.clone()
                                    for k, t in m.state_dict().items()},
                          "eval": ev, "serve": served, "counts": counts}
    finally:
        close_world(world)
    one, w1 = runs["one device"], runs["world 1"]
    assert one["loss"] == w1["loss"]
    assert set(one["grads"]) == set(w1["grads"])
    assert all(torch.equal(one["grads"][n], g)
               for n, g in w1["grads"].items())
    assert all(torch.equal(one["state"][k], t)
               for k, t in w1["state"].items())
    for k in ("count", "joint_err", "surface_err"):
        assert one["eval"][k] == w1["eval"][k], k
    for k in ("pred_mesh_mm", "mesh"):
        assert np.array_equal(one["eval"][k], w1["eval"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(one["serve"], w1["serve"]))
    assert all(n > 0 for n in w1["counts"].values()), w1["counts"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_sample_base_masks_are_rows_of_the_whole_batch(card, dp, kernel):
    """K5's and K4's dropout masks exported at sample0 = 64 equal rows
    [64, 128) of a 128 batch's and their plain versions', bit for bit
    (bf16, default rates)."""
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train_ref)
    from gator_tpu_torch.nn.lbf_stack_train import (extract_layer_params,
                                                    lbf_stack_train_ref)

    model, half = dp["model"], 64
    gat, mdr = model.pose_lifter, model.pose2mesh
    gen = torch.Generator().manual_seed(30)
    if kernel == "K5":
        x = torch.randn(2 * half, 17, 128, generator=gen).to(card, BF16)
        bias = gat.get_hop_path_encoding().float()
        blocks = [extract_block_params(blk) for blk in gat.blocks]

        def call(fn, rows, **kw):
            return fn(x[rows], bias, blocks, gat.spec.masks_xfeat, 8, 99,
                      **kw)
        fn, ref = gat_trunk_train, gat_trunk_train_ref
    else:
        x = torch.randn(2 * half, 431, 64, generator=gen).to(card, BF16)
        j = torch.randn(2 * half, 17, 64, generator=gen).to(card, BF16)
        layers = [extract_layer_params(mdr, i) for i in range(3)]

        def call(fn, rows, **kw):
            return fn(x[rows], j[rows], layers, 2, 99, **kw)
        fn, ref = lbf_stack_train, lbf_stack_train_ref
    whole, part, plain = [], [], []
    with torch.no_grad():
        call(fn, slice(None), export=whole)
        call(fn, slice(half, None), export=part, sample0=half)
        call(ref, slice(half, None), export=plain, sample0=half)
    torch.cuda.synchronize()

    def same(a, b):
        """Bit-equal masks, None (rate 0, no draw) being all ones."""
        if a is None or b is None:
            other = b if a is None else a
            return other is None or bool((other == 1).all())
        return a.shape == b.shape and bool((a == b).all())

    n = 0
    for wu, pu, qu in zip(whole, part, plain):
        for k, got in pu.items():
            assert same(got, None if wu[k] is None else wu[k][half:]), k
            assert same(got, qu[k]), k
            n += 1
    assert n > 0


def _dp_cases(dp):
    """The data-parallel checks' cases: the bf16 and f32 stage-2 steps,
    `run_eval` and the f32 serving call."""
    step = {"kind": "step", "assets": dp["assets"], "spec": {},
            "state_dict": dp["state_dict"], "batch": dp["batch"], "seed": 7,
            "lr": 1e-4}
    common = {"assets": dp["assets"], "spec": {},
              "state_dict": dp["state_dict"]}
    return [dict(step, dtype="bfloat16"), dict(step, dtype="float32"),
            dict(common, kind="eval", batches=dp["evals"],
                 collect_out=("pred_mesh_mm",), collect_batch=("mesh",)),
            dict(common, kind="serve", poses=dp["poses"], dtype="float32")]


# the parameters whose gradients K4 and K5 compute (f32); in bf16 the
# others come from bf16 products that each rank rounds before the
# all-reduce: one bf16 ulp, 2^-7 of the largest element
KERNEL_PARAMS = ("pose_lifter.blocks.", "pose2mesh.encoder", "pose2mesh.norm",
                 "pose2mesh.selfatt")


def _dp_readings(got, want):
    """Each bar's reading of a rank's step against one process's."""
    def part(st, kernel):
        return {n: torch.from_numpy(g) for n, g in st["grads"].items()
                if n.startswith(KERNEL_PARAMS) == kernel}

    bn = max(scaled(torch.from_numpy(got["buffers"][k]),
                    torch.from_numpy(want["buffers"][k]))
             for k in ("pose2mesh.bias_norm.running_mean",
                       "pose2mesh.bias_norm.running_var"))
    return {"loss rel": abs(got["metrics"]["loss"] - want["metrics"]["loss"])
            / abs(want["metrics"]["loss"]),
            "K4/K5 parameter gradients": worst_grad(
                part(got, True), part(want, True))[0],
            "the others": worst_grad(part(got, False),
                                     part(want, False))[0],
            "running stats": bn}


def _dp_bars(dtype):
    return {"loss rel": 1e-4, "K4/K5 parameter gradients": 1e-3,
            "the others": 1e-3 if dtype == "float32" else 2 ** -7,
            "running stats": 1e-4}


def _hold_ranks(dp, want, ranks):
    """Every rank's step, eval and serving against one process's on the
    global batch; the eval rows and served meshes also bit for bit against
    the one-device path on each rank's rows (f32 rounding moves with the
    batch's partition)."""
    from gator_tpu_torch.parallel import pad_to_multiple
    from gator_tpu_torch.train import make_gator_eval_step

    n = len(ranks)
    assets, model = dp["assets"], dp["model"]
    chunks, keep, at = [], [], 0
    for e in dp["evals"]:
        padded, real = pad_to_multiple(e, n)
        size = len(padded["pose2d"]) // n
        chunks += [{k: a[i * size:(i + 1) * size] for k, a in padded.items()}
                   for i in range(n)]
        keep.append(at + np.arange(real))
        at += n * size
    estep = make_gator_eval_step(assets.j_regressor_h36m,
                                 assets.joint_set.eval_joints)
    rows = run_eval(estep, model, chunks,
                    collect_out=("pred_mesh_mm",))["pred_mesh_mm"][
        np.concatenate(keep)]
    serve = make_serving_fn(model, F32)
    poses = torch.from_numpy(dp["poses"]).to("cuda")
    meshes = torch.cat([serve(p)[0] for p in poses.split(len(poses) // n)]
                       ).cpu().numpy()
    for r, (s16, s32, ev, sv) in enumerate(ranks):
        for st, ref, dtype in ((s16, want[0], "bfloat16"),
                               (s32, want[1], "float32")):
            got, bar = _dp_readings(st, ref), _dp_bars(dtype)
            assert all(got[k] <= bar[k] for k in bar), (r, dtype, got)
            assert all(c > 0 for c in st["launches"].values()), st["launches"]
        assert ev["count"] == want[2]["count"] == 377
        for k in ("joint_err", "surface_err"):
            assert abs(ev[k] - want[2][k]) <= 1e-6 * abs(want[2][k]), (r, k)
        assert np.array_equal(ev["pred_mesh_mm"], rows), r
        assert np.array_equal(ev["mesh"], want[2]["mesh"]), r
        assert np.array_equal(sv["mesh"], meshes), r
        assert np.abs(sv["mesh"] - want[3]["mesh"]).max() <= 1e-6, r


@pytest.mark.cuda
def test_world_2_over_gloo_on_one_card(card, dp):
    """Two ranks over gloo, both on cuda:0, against one process on the
    global batch (`_hold_ranks`); and a negative control: the bf16 step
    with a planted fault (masks keyed from sample 0 on both ranks; the
    BatchNorm statistics not all-reduced), which a bar must catch."""
    from gator_tpu_torch.parallel import spawn
    from gator_tpu_torch.parallel.checks import run_cases

    cases = _dp_cases(dp)
    want = run_cases(None, [dict(c, device="cuda:0") for c in cases])
    planted = [dict(cases[0], fault=f) for f in ("sample0", "bn")]
    ranks = spawn(planted_cases, 2, backend="gloo", devices="cuda:0",
                  args=(cases + planted,), timeout=300)
    _hold_ranks(dp, want, [r[:4] for r in ranks])
    for r, rank in enumerate(ranks):
        for case, st in zip(planted, rank[4:]):
            got, bar = _dp_readings(st, want[0]), _dp_bars("bfloat16")
            assert any(got[k] > bar[k] for k in bar), (r, case["fault"], got)


@pytest.mark.cuda
def test_nccl_across_cards(card, dp):
    """One rank per card over NCCL (2, 4 or 8 of the host's cards) against
    one process on the global batch, as over gloo."""
    from gator_tpu_torch.parallel import spawn
    from gator_tpu_torch.parallel.checks import run_cases

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"NCCL across cards needs 2 or more; this host has "
                    f"{cards}")
    n = max(k for k in (2, 4, 8) if k <= cards)
    cases = _dp_cases(dp)
    want = run_cases(None, [dict(c, device="cuda:0") for c in cases])
    ranks = spawn(run_cases, n, backend="nccl",
                  devices=[f"cuda:{r}" for r in range(n)], args=(cases,),
                  timeout=300)
    _hold_ranks(dp, want, ranks)
