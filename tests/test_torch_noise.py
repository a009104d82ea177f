"""The port's host input code (data/coords.py, augment.py, noise.py,
processing.py and base.input_pose2d) against the JAX package's: the same
inputs, and one seed per side, give bit-equal results, the detector-noise
simulators included (every draw in the same order)."""
import numpy as np
import pytest

from gator_tpu.assets import COCO, H36M
from gator_tpu.data import augment as jaug
from gator_tpu.data import base as jbase
from gator_tpu.data import coords as jcoords
from gator_tpu.data import noise as jnoise
from gator_tpu.data import processing as jproc
from gator_tpu_torch.data import augment, base, coords, noise, processing

JSETS = {"human36": H36M, "coco": COCO}


def _kps(rng, b, j=17, lo=80.0, hi=420.0):
    return rng.uniform(lo, hi, size=(b, j, 2)).astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pair(fn, *args, **kw):
    """(port result, JAX result) of the function `fn` names, each side
    with its own generator from one seed where the call takes one."""
    mods = {"coords": (coords, jcoords), "augment": (augment, jaug),
            "noise": (noise, jnoise), "processing": (processing, jproc)}
    mod, name = fn.split(".")
    out = []
    for m in mods[mod]:
        call = {k: (np.random.default_rng(v.seed) if isinstance(v, _Seed)
                    else v) for k, v in kw.items()}
        out.append(getattr(m, name)(*args, **call))
    return out


class _Seed:
    def __init__(self, seed):
        self.seed = seed


def test_coords_functions_bit_equal():
    rng = np.random.default_rng(0)
    kp = _kps(rng, 1)[0]
    for fn, args in (
            ("get_center_scale", ([10.5, 20.0, 300.0, 400.0],)),
            ("get_bbox", (kp,)),
            ("process_bbox", ([10.5, 20.0, 300.0, 400.0], 0.75)),
            ("process_bbox", ([10.5, 20.0, 400.0, 300.0], 0.75, 1.25)),
            ("process_bbox", ([10.0, 20.0, 0.0, 30.0], 0.75)),
            ("cam2pixel", (rng.normal(0, 300, (17, 3)) + [0, 0, 4000.0],
                           [1500.0, 1490.0], [500.0, 510.0])),
            ("world2cam", (rng.normal(0, 300, (17, 3)),
                           rng.normal(size=(3, 3)), [1.0, 2.0, 3.0])),
            ("pixel2cam", (rng.uniform(1, 500, (17, 3)),
                           np.array([500.0, 510.0]),
                           np.array([1500.0, 1490.0]))),
            ("rigid_align_np", (rng.normal(size=(14, 3)),
                                rng.normal(size=(14, 3))))):
        got, want = _pair(f"coords.{fn}", *args)
        if want is None:
            assert got is None
        elif isinstance(want, tuple):
            for g, w in zip(got, want):
                _same(g, w)
        else:
            _same(got, want)


@pytest.mark.parametrize("rot,flip", [(0.0, False), (23.5, False),
                                      (-41.0, True)])
def test_augment_functions_bit_equal(rot, flip):
    rng = np.random.default_rng(1)
    kp = np.concatenate([_kps(rng, 1)[0], np.ones((17, 1), np.float32)], 1)
    pairs = H36M.flip_pairs
    bbox = np.array([60.0, 40.0, 300.0, 380.0], np.float32)
    j3 = rng.normal(0, 300, (17, 3)).astype(np.float32)
    for fn, args in (
            ("transform_joint_to_other_db", (j3, COCO.joints_name[:17],
                                             H36M.joints_name)),
            ("get_affine_transform", ((150.0, 200.0), (300.0, 380.0), rot,
                                      (288, 384))),
            ("get_affine_transform", ((150.0, 200.0), (300.0, 380.0), rot,
                                      (288, 384), True)),
            ("flip_2d_joint", (kp, 288, pairs)),
            ("flip_3d_joint", (j3, pairs)),
            ("j2d_processing", (kp, (288, 384), bbox, rot, flip, pairs)),
            ("j3d_processing", (j3, rot, flip, pairs)),
            ("normalize_input_pose", (kp, (384, 288)))):
        got, want = _pair(f"augment.{fn}", *args)
        for g, w in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            _same(g, w)
    trans = jaug.get_affine_transform((150.0, 200.0), (300.0, 380.0), rot,
                                      (288, 384))
    _same(augment.affine_transform(kp[3], trans),
          jaug.affine_transform(kp[3], trans))
    _same(augment.affine_transform_batch(kp[:, :2], trans),
          jaug.affine_transform_batch(kp[:, :2], trans))


@pytest.mark.parametrize("is_train,flip_enabled", [(True, True),
                                                   (True, False),
                                                   (False, True)])
def test_augm_params_bit_equal(is_train, flip_enabled):
    got, want = _pair("augment.augm_params", is_train, flip_enabled, 30.0,
                      rng=_Seed(5))
    assert got == want
    got, want = _pair("augment.augm_params_batch", is_train, flip_enabled,
                      30.0, 64, rng=_Seed(5))
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_h36m_syn_error_bit_equal():
    stats = noise.h36m_error_stats(H36M.joints_name)
    _same(stats, jnoise.h36m_error_stats(H36M.joints_name))
    got, want = _pair("noise.generate_h36m_syn_error", stats, rng=_Seed(3))
    _same(got, want)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("n_valid", [17, 9, 4])
def test_synthesize_pose_bit_equal(n_valid):
    """The per-sample COCO simulator, with every valid-count table (the
    probabilities switch at 5 and 10 valid joints)."""
    rng = np.random.default_rng(n_valid)
    joints = np.concatenate([_kps(rng, 1)[0],
                             np.zeros((17, 1), np.float32)], 1)
    joints[:n_valid, 2] = 1
    got, want = _pair("noise.synthesize_pose", joints, 9000.0,
                      rng=_Seed(n_valid))
    _same(got, want)


def test_synthesize_pose_batch_bit_equal():
    """The batched simulator: mixed valid counts and areas, a zero-area
    row (every candidate radius 0)."""
    rng = np.random.default_rng(4)
    b = 48
    joints = np.concatenate([_kps(rng, b), np.ones((b, 17, 1), np.float32)],
                            2)
    joints[:8, 11:, 2] = 0
    joints[8:12, 4:, 2] = 0
    areas = rng.uniform(2000, 40000, b).astype(np.float32)
    areas[-1] = 0.0
    got, want = _pair("noise.synthesize_pose_batch", joints, areas,
                      rng=_Seed(6))
    _same(got, want)
    assert not np.array_equal(got[:, :, :2], joints[:, :, :2])


def _opts(js, use_gt, is_train, **kw):
    o = dict(input_joint_name=js, use_gt_input=use_gt, is_train=is_train,
             **kw)
    return processing.ProcessOptions(**o), jproc.ProcessOptions(**o)


@pytest.mark.parametrize("branch", ["gt", "detected", "h36m", "coco"])
def test_crop_and_normalize_input_bit_equal(branch):
    js = "coco" if branch == "coco" else "human36"
    jset = JSETS[js]
    rng = np.random.default_rng(7)
    kp = _kps(rng, 1, jset.joint_num)[0]
    popts, jopts = _opts(js, branch == "gt", True)
    kw = {"detected": {"detected_pose": _kps(rng, 1, jset.joint_num)[0]},
          "h36m": {"h36m_noise_stats": noise.h36m_error_stats(
              H36M.joints_name)},
          "coco": {"coco_noise_area": 12000.0}, "gt": {}}[branch]
    for flip, rot in ((0, 0.0), (1, 17.0)):
        got = processing.crop_and_normalize_input(
            kp, jset, popts, np.random.default_rng(8), flip, rot, **kw)
        want = jproc.crop_and_normalize_input(
            kp, jset, jopts, np.random.default_rng(8), flip, rot, **kw)
        _same(got, want)


@pytest.mark.parametrize("js", ["human36", "coco"])
def test_crop_area_and_targets_bit_equal(js):
    jset = JSETS[js]
    rng = np.random.default_rng(9)
    kp = _kps(rng, 6, jset.joint_num)
    kp[0, :, 0] = 100.0                          # degenerate: area 1
    popts, jopts = _opts(js, False, True)
    _same(processing.crop_area_batch(kp, popts),
          jproc.crop_area_batch(kp, jopts))
    for i in range(len(kp)):
        assert processing.crop_area(kp[i], popts) == \
            jproc.crop_area(kp[i], jopts)
    mesh = rng.normal(0, 300, (50, 3)).astype(np.float32)
    lift = rng.normal(0, 300, (jset.joint_num, 3)).astype(np.float32)
    h36 = rng.normal(0, 300, (17, 3)).astype(np.float32)
    for fit in (3.0, 90.0):
        got = processing.gator_targets(mesh, lift, h36, fit, popts, 1, 20.0,
                                       jset)
        want = jproc.gator_targets(mesh, lift, h36, fit, jopts, 1, 20.0,
                                   jset)
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])


@pytest.mark.parametrize("branch", ["gt_train", "gt_test", "detected",
                                    "h36m", "coco"])
def test_input_pose2d_bit_equal(branch):
    """base.input_pose2d (what every reader's batch goes through) in each
    branch, augmentation on, from one seed; the draws after it (the next
    draw of each generator) agree too, so the order is the same."""
    js = "coco" if branch == "coco" else "human36"
    jset = JSETS[js]
    b = 32
    rng = np.random.default_rng(10)
    kp = _kps(rng, b, jset.joint_num)
    dets = _kps(rng, b, jset.joint_num)
    use_gt = branch in ("gt_train", "gt_test")
    is_train = branch != "gt_test" and branch != "detected"
    popts, jopts = _opts(js, use_gt, is_train, flip_enabled=True,
                         rotate_factor=30.0)
    stats = noise.h36m_error_stats(
        ("Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
         "L_Ankle", "Torso", "Neck", "Nose", "Head", "L_Shoulder",
         "L_Elbow", "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist"))
    outs = []
    for opts, mod, aug in ((popts, base, augment), (jopts, jbase, jaug)):
        g = np.random.default_rng(11)
        flips, rots = aug.augm_params_batch(
            opts.is_train, opts.flip_enabled, opts.rotate_factor, b, g)
        pose = mod.input_pose2d(opts, jset, g, kp, flips, rots,
                                detected_pose=dets, h36m_stats=stats)
        outs.append((pose, flips, rots, g.uniform()))
    for got, want in zip(*outs):
        _same(got, want)
    if branch in ("h36m", "coco", "detected"):
        clean = processing.batch_crop_and_normalize(
            kp, jset, popts, outs[0][1], outs[0][2])
        assert not np.array_equal(outs[0][0], clean)
