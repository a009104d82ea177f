"""Helpers the port's tests share; not collected (no test in it).

`write_fixtures` writes fabricated dataset trees in the readers' real
annotation schemas: tests/test_torch_readers.py, tests/test_torch_cli_test.py
and tests/test_torch_paths_cuda.py read them through $GATOR_DATA_DIR.
`noise_same_draws` is the rule that holds two runs of the device
detector-noise simulator from the same draws to one function
(tests/test_torch_device_noise.py against the JAX package on the CPU,
tests/test_torch_paths_cuda.py the card against the CPU). `planted_cases`
runs the data-parallel checks with a fault planted, for the card's
negative control. `scaled`, `grads` and `worst_grad` compare a kernel's
gradients with its plain version's (tests/test_torch_train_kernels_cuda.py,
tests/test_torch_paths_cuda.py); `launched` and `only` read the main-path
kernels' launch counters around a block (the card tests). This module
imports no JAX.
"""
import contextlib
import json
import os

import numpy as np
import torch

# -- fabricated dataset trees in the real annotation schemas --------------

H36M_SUBJECTS = {"train": (1, 5, 6, 7, 8), "test": (9, 11)}


def _h36m_name(s, act, cam, frame):
    stem = f"s_{s:02d}_act_{act:02d}_subact_01_ca_{cam:02d}"
    return f"{stem}/{stem}_{frame:06d}.jpg"


def _rot_y(yaw):
    cs, sn = np.cos(yaw), np.sin(yaw)
    return np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])


def _smpl_param(rng, trans=None):
    """An SMPL fit: pose, shape and, where the schema has one, trans."""
    param = {"pose": (0.2 * rng.standard_normal(72)).round(5).tolist(),
             "shape": rng.uniform(-1, 1, 10).round(5).tolist()}
    if trans is not None:
        param["trans"] = list(trans)
    return param


def write_fixtures(root, h36m_test=2048, h36m_train=1280, pw3d=512,
                   coco=1024, muco=1024, seed=0):
    """Write Human36M (train subjects 1/5/6/7/8 at every 5th frame, cameras
    1-4; test subjects 9/11 at every 50th frame, camera 4, with
    absnet_output_on_testset.json), 3DPW test (both genders, DarkPose
    detections), COCO and MuCo train trees under `root`, in the schemas the
    readers parse (gator_tpu_torch/data/{h36m,pw3d,coco_ds,muco}.py). Rows
    are random, from `seed`: plausible SMPL fits, cameras ~5 m away, joints
    and keypoints of body scale. The last frame of each test subject has no
    SMPL fit (the readers skip it, and its detection)."""
    rng = np.random.default_rng(seed)

    def dump(obj, *parts):
        path = os.path.join(root, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)

    dets, next_id = {}, 0
    for split, n_total in (("train", h36m_train), ("test", h36m_test)):
        subjects = H36M_SUBJECTS[split]
        step, cams = (5, (1, 2, 3, 4)) if split == "train" else (50, (4,))
        per = -(-n_total // (len(subjects) * len(cams)))
        for s in subjects:
            cameras = {str(c): {
                "R": _rot_y(0.5 * c - 1.2).round(6).tolist(),
                "t": [0.0, 0.0, 5000.0], "f": [1145.0, 1144.0],
                "c": [512.0, 515.0]} for c in cams}
            images, anns, joints, smpls = [], [], {}, {}
            for k in range(per):
                act = 2 + k % 15
                frame = step * (k // 15)
                joints.setdefault(str(act), {"1": {}})
                smpls.setdefault(str(act), {"1": {}})
                world = rng.normal(0, 250, (17, 3))
                joints[str(act)]["1"][str(frame)] = world.round(3).tolist()
                if not (split == "test" and k == per - 1):
                    smpls[str(act)]["1"][str(frame)] = _smpl_param(
                        rng, [0.0, 0.0, 0.0])
                for c in cams:
                    img_id, next_id = next_id, next_id + 1
                    name = _h36m_name(s, act, c, frame)
                    images.append({
                        "id": img_id, "file_name": name, "frame_idx": frame,
                        "subject": s, "action_idx": act, "subaction_idx": 1,
                        "cam_idx": c, "height": 1002, "width": 1000})
                    anns.append({"id": img_id, "image_id": img_id,
                                 "bbox": [300.0, 150.0, 420.0, 700.0]})
                    if split == "test":
                        cam = np.array(cameras[str(c)]["R"])
                        jc = world @ cam.T + [0, 0, 5000.0]
                        xy = jc[:, :2] / jc[:, 2:] * 1145.0 + 512.0
                        xy = xy + rng.normal(0, 4.0, xy.shape)
                        dets[name.split("/")[-1]] = np.concatenate(
                            [xy, np.ones((17, 1))], 1).round(3).tolist()
            base = ("Human36M", "annotations", f"Human36M_subject{s}")
            dump({"images": images, "annotations": anns},
                 *base[:-1], base[-1] + "_data.json")
            dump(cameras, *base[:-1], base[-1] + "_camera.json")
            dump(joints, *base[:-1], base[-1] + "_joint_3d.json")
            dump(smpls, *base[:-1], base[-1] + "_smpl_param.json")
    dump(dets, "Human36M", "absnet_output_on_testset.json")

    images, anns, dark = [], [], []
    for i in range(pw3d):
        images.append({"id": i, "width": 1080, "height": 1920,
                       "sequence": f"courtyard_{i // 64:02d}",
                       "file_name": f"image_{i % 64:05d}.jpg",
                       "cam_param": {"focal": [1961.0, 1969.0],
                                     "princpt": [540.0, 960.0]}})
        param = _smpl_param(rng, [0.0, 0.2, 4.0])
        param["gender"] = "female" if i % 2 else "male"
        anns.append({"id": i, "image_id": i, "person_id": i % 2,
                     "bbox": [300.0, 500.0, 420.0, 900.0],
                     "smpl_param": param})
        kp = np.concatenate([rng.uniform(350, 700, (17, 1)),
                             rng.uniform(550, 1350, (17, 1)),
                             rng.uniform(0.3, 1.0, (17, 1))], 1)
        dark.append({"annotation_id": i, "keypoints": kp.round(3).tolist()})
    dump({"images": images, "annotations": anns},
         "PW3D", "data", "3DPW_latest_test.json")
    dump(dark, "PW3D", "data", "darkpose_3dpw_testset_output.json")

    anns, fits = [], {}
    for i in range(coco):
        kp = np.concatenate([rng.uniform(100, 400, (17, 2)),
                             np.full((17, 1), 2.0)], 1)
        anns.append({"id": i, "iscrowd": 0, "num_keypoints": 17,
                     "keypoints": kp.round(3).flatten().tolist(),
                     "bbox": [90.0, 80.0, 320.0, 380.0]})
        fits[str(i)] = {"smpl_param": _smpl_param(rng),
                        "cam_param": {"s": [float(rng.uniform(150, 250))],
                                      "t": rng.uniform(150, 250,
                                                       2).tolist()}}
    dump({"annotations": anns},
         "COCO", "annotations", "person_keypoints_train2017.json")
    dump(fits, "COCO", "annotations", "coco_smplify_train.json")

    images, anns, params = [], [], {}
    for i in range(muco):
        images.append({"id": i, "f": [1500.0, 1500.0], "c": [1000.0, 1000.0]})
        for p in range(1 + i % 2):          # every other image: two people
            aid = 2 * i + p
            kc = rng.uniform(-400, 400, (21, 3))
            kc[:, 2] += 3000.0 + 1000.0 * p
            anns.append({"id": aid, "image_id": i,
                         "bbox": [60.0 + 40 * p, 60.0, 300.0, 400.0],
                         "keypoints_cam": kc.round(3).tolist()})
            params[str(aid)] = _smpl_param(rng, [0.0, 0.0, 3.0 + p])
    dump({"images": images, "annotations": anns},
         "MuCo", "data", "MuCo-3DHP.json")
    dump(params, "MuCo", "data", "smpl_param.json")


# -- detector noise on the device ------------------------------------------

# the h36m joints in the readers' order (data/base.py)
H36M_JOINTS = ("Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
               "L_Ankle", "Torso", "Neck", "Nose", "Head", "L_Shoulder",
               "L_Elbow", "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist")


def noise_boundary_cases(joints, areas, draws, out):
    """[B, 17] True where a (row, joint) of `synthesize_pose_device` on
    all-visible joints, fed the draws `draws` ({path: array}), is a
    boundary case of the run that gave `out`: a candidate of one of its
    five annuli within 1e-3 px of its acceptance radius, or its state
    uniform within 1e-6 of a cumulative-probability edge (a float64
    recomputation from the same draws). An ulp of cos, sin or a sum moves
    such a case across its edge."""
    from gator_tpu_torch.data import device_noise as dn
    from gator_tpu_torch.data import noise

    b = len(joints)
    var = (noise.KPS_SIGMAS * 2) ** 2
    a = areas.astype(np.float64)[:, None]
    ks10, ks50, ks85 = (np.sqrt(-2.0 * a * var * np.log(q))
                        for q in (0.10, 0.50, 0.85))
    near = np.zeros((b, 17), bool)
    for w, wave in enumerate((dn._WAVE1, dn._WAVE2)):
        pair = noise._PAIR[wave]
        gt = joints[:, wave].astype(np.float64)
        # wave 2's pairs were synthesised in wave 1
        src = out if w == 1 else joints
        pp = np.where((pair >= 0)[None, :, None],
                      src[:, np.maximum(pair, 0)], 0.0).astype(np.float64)
        has = np.broadcast_to(pair >= 0, (b, len(wave)))
        every = np.ones_like(has)
        k85, k50, k10 = ks85[:, wave], ks50[:, wave], ks10[:, wave]
        zero = np.zeros_like(k85)
        ann = {1: (gt, k85, k50, pp, has, None),
               3: (gt, zero, k85, pp, has, None),
               5: (pp, zero, k50, gt, every, None),
               6: (gt, k50, k10, pp, has, k50),
               7: (pp, k50, k10, gt, every, k50)}
        ok = {}
        for i, (c, lo, hi, other, ovalid, rr) in ann.items():
            ang = np.asarray(draws[(w, i, 0)], np.float64) \
                * float(np.float32(2 * np.pi))
            r = (np.asarray(draws[(w, i, 1)], np.float64)
                 * (hi - lo)[..., None] + lo[..., None])
            d = np.hypot(c[..., 0, None] + r * np.cos(ang)
                         - other[..., 0, None],
                         c[..., 1, None] + r * np.sin(ang)
                         - other[..., 1, None])
            radius = r if rr is None else rr[..., None]
            near[:, wave] |= ((np.abs(d - radius) < 1e-3)
                              & ovalid[..., None]).any(-1)
            ok[i] = np.where(ovalid[..., None], d > radius, True)
        w_p = np.floor((ok[7] & has[..., None]).sum(-1) / 4.0)
        jit, miss, inv = (noise._JIT_HIGH[wave], noise._MISS_HIGH[wave],
                          noise._INV_P[wave])
        probs = np.stack([jit * ok[1].any(-1),
                          miss * (ok[6].sum(-1) + w_p > 0),
                          inv * (ok[5].any(-1) & has),
                          (1 - jit - miss - inv) * ok[3].any(-1)], -1)
        u = np.asarray(draws[(w, 11)], np.float64) \
            * np.maximum(probs.sum(-1), 1e-12)
        near[:, wave] |= (np.abs(u[..., None] - np.cumsum(probs, -1))
                          < 1e-6).any(-1)
    return near


def noise_same_draws(joints, areas, draws, got, want):
    """The shared-draws rule: `got` and `want` ([B, 17, 2], one
    simulator's output each from the same draws) agree within 1e-3 px on
    every (row, joint) but at most 0.2 % boundary cases, each one a
    boundary case of its own (`noise_boundary_cases`) or downstream of its
    wave-1 pair's. -> (cases beyond 1e-3 px, of them explained, max error
    of the rest); fails an assertion if the rule fails."""
    from gator_tpu_torch.data import device_noise as dn
    from gator_tpu_torch.data import noise

    err = np.abs(got - want).max(-1)
    off = err > 1e-3
    near = noise_boundary_cases(joints, areas, draws, want)
    upstream = np.zeros_like(off)
    for j in dn._WAVE2:
        p = noise._PAIR[j]
        upstream[:, j] = off[:, p] & near[:, p]
    explained = off & (near | upstream)
    rest = float(err[~off].max()) if (~off).any() else 0.0
    assert off.mean() <= 0.002 and not (off & ~explained).any(), (
        f"shared draws: {int(off.sum())} of {off.size} beyond 1e-3 px "
        f"(bar 0.2 %), unexplained at {np.argwhere(off & ~explained)}")
    return int(off.sum()), int(explained.sum()), rest


def planted_cases(world, cases):
    """`run_cases` for the data-parallel negative control: a case with a
    "fault"
    runs with that fault planted in this process. "sample0": every rank
    keys its dropout masks from sample 0, as if the step gave K4 and K5 no
    sample base; "bn": the BatchNorm statistics over this rank's rows
    alone, as if they were not all-reduced. A rank imports it by this
    module's name (`parallel.spawn`)."""
    from unittest import mock

    from gator_tpu_torch.parallel.checks import run_cases
    from gator_tpu_torch.train import fused_forward, loop

    stats = fused_forward.batch_stats
    faults = {
        "sample0": lambda: mock.patch.object(loop, "_sample0",
                                             lambda batch, world: 0),
        "bn": lambda: mock.patch.object(fused_forward, "batch_stats",
                                        lambda m32, world=None: stats(m32)),
    }
    out = []
    for case in cases:
        fault = case.get("fault")
        with (faults[fault]() if fault else contextlib.nullcontext()):
            out += run_cases(world, [case])
    return out



# -- a kernel's gradients against its plain version's ---------------------


def scaled(a, b):
    """max |a - b| as a share of max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def grads(module, prefix=""):
    """{name: a copy of its gradient} of the parameters named from
    `prefix` (a string or a tuple of them) that have one."""
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None and n.startswith(prefix)}


def _key_bias(name, g):
    """The slice of a gradient that is zero in exact arithmetic: the GAT
    qkv bias's keys, the MDR self-attention's key bias."""
    if name.endswith("attn.qkv.bias"):
        c = g.shape[0] // 3
        return slice(c, 2 * c)
    if "selfatt" in name and name.endswith("linears.1.bias"):
        return slice(0, g.shape[0])
    return None


def worst_grad(got, want):
    """(the largest `scaled` error over the gradients, key-bias slices
    apart, its gradient's name); both dicts name the same gradients."""
    assert set(got) == set(want) and got
    worst, which = 0.0, None
    for name, w in want.items():
        g, zero = got[name], _key_bias(name, w)
        if zero is not None:
            keep = torch.ones_like(g, dtype=torch.bool)
            keep[zero] = False
            g, w = g[keep], w[keep]
            if g.numel() == 0:
                continue
        e = scaled(g, w)
        assert np.isfinite(e), name
        if e >= worst:
            worst, which = e, name
    return worst, which


# -- the main-path kernels' launches around a block ------------------------


def _counts():
    from gator_tpu_torch.nn import gat_trunk, lbf_stack
    from gator_tpu_torch.nn.fused_attention import fused_attention
    from gator_tpu_torch.nn.gat_trunk_train import gat_trunk_train as k5
    from gator_tpu_torch.nn.lbf_stack_train import lbf_stack_train as k4
    return {"gat_trunk": gat_trunk.launches, "lbf_stack": lbf_stack.launches,
            "fused_attention": fused_attention.launches,
            "gat_trunk_train_fwd": k5.launches_fwd,
            "gat_trunk_train_bwd": k5.launches_bwd,
            "lbf_stack_train_fwd": k4.launches_fwd,
            "lbf_stack_train_bwd": k4.launches_bwd}


@contextlib.contextmanager
def launched():
    """-> a dict that, when the block ends, holds each kernel's launches
    inside it (after a synchronize)."""
    torch.cuda.synchronize()
    before = _counts()
    got = {}
    yield got
    torch.cuda.synchronize()
    got.update({k: n - before[k] for k, n in _counts().items()})


def only(counts, *names, **exactly):
    """The kernels named launched (those given a number that many times),
    every other kernel not at all."""
    for name, n in counts.items():
        if name in exactly:
            assert n == exactly[name], counts
        else:
            assert (n > 0) == (name in names), counts
