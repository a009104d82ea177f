"""Detector-noise simulation for 2D pose inputs (host numpy, explicit
generator; counterpart of gator_tpu/data/noise.py). Two mechanisms, as in
the reference:
  * `synthesize_pose` / `synthesize_pose_batch`: the COCO keypoint error
    simulator, per joint one of jitter / miss / inversion / good with radii
    from the OKS sigmas (reference: lib/noise_utils.py:17-285; its swap
    branch is dead code and its `near_joints` table all zeros, so both are
    omitted);
  * `h36m_error_stats` + `generate_h36m_syn_error`: per-joint Gaussian
    detector error of Human3.6M (data: AbsPoseLifter's statistics, as
    bundled in the reference's data/Human36M/noise_stats.py, applied at
    Human36M/dataset.py:143-155).
The code and the order of its draws are the JAX package's, so one
generator gives both packages bit-equal noise.
"""
from __future__ import annotations

import numpy as np

# COCO keypoint OKS sigmas / 10 (reference: noise_utils.py:9-11)
KPS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87,
    .87, .89, .89]) / 10.0
NUM_KPS = 17
KPS_SYMMETRY = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
                (15, 16))

# (mean_x, mean_y, std_x, std_y, weight) keyed by h36m joint name
# (data: AbsPoseLifter error statistics, via reference noise_stats.py)
H36M_ERROR_STATS = {
    "Pelvis":     (-0.06, -2.37, 1.33, 2.13, 1.00),
    "R_Hip":      (-0.83, -2.07, 3.41, 2.69, 1.00),
    "R_Knee":     (-0.04, -1.01, 1.74, 2.20, 0.95),
    "R_Ankle":    (0.52, -3.40, 1.39, 2.14, 0.93),
    "L_Hip":      (0.78, -2.79, 3.26, 2.28, 1.00),
    "L_Knee":     (0.42, -0.15, 1.53, 1.99, 0.94),
    "L_Ankle":    (-0.15, -3.78, 1.39, 2.39, 0.93),
    "Torso":      (-0.05, 0.10, 1.36, 1.74, 0.99),
    "Neck":       (0.14, -2.56, 1.18, 1.15, 0.99),
    "Head":       (0.09, 0.49, 1.35, 0.87, 0.99),
    "Nose":       (0.13, -0.26, 0.78, 0.59, 0.98),
    "L_Shoulder": (-0.19, 0.31, 2.51, 1.48, 0.99),
    "L_Elbow":    (0.11, -0.60, 1.79, 1.76, 0.95),
    "L_Wrist":    (-0.02, 0.88, 2.02, 2.10, 0.91),
    "R_Shoulder": (0.52, -0.12, 2.23, 1.73, 0.99),
    "R_Elbow":    (0.06, -0.44, 1.93, 1.63, 0.95),
    "R_Wrist":    (0.05, 0.16, 2.02, 2.24, 0.90),
}


def h36m_error_stats(joints_name) -> np.ndarray:
    """[J, 5] (mean_x, mean_y, std_x, std_y, weight) ordered by joint name
    (reference: Human36M/dataset.py:135-141)."""
    return np.array([H36M_ERROR_STATS[n] for n in joints_name],
                    dtype=np.float32)


def generate_h36m_syn_error(stats: np.ndarray,
                            rng: np.random.Generator) -> np.ndarray:
    """Sample per-joint 2D detector error (256-crop pixel units); each
    joint perturbed with probability `weight`
    (reference: Human36M/dataset.py:143-155)."""
    j = stats.shape[0]
    noise = rng.normal(loc=stats[:, 0:2], scale=stats[:, 2:4]).astype(
        np.float32)
    keep = (stats[:, 4] > rng.uniform(size=j)).astype(np.float32)
    return noise * keep[:, None]


def _pair_index(j: int):
    for q, w in KPS_SYMMETRY:
        if j == q:
            return w
        if j == w:
            return q
    return None


def _sample_annulus(rng, center, r_lo, r_hi, n, reject_centers, reject_r):
    """n candidates uniform in the annulus [r_lo, r_hi] around center,
    rejecting points within reject_r(x) of any other candidate center;
    returns [k, 2] accepted points."""
    angle = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(r_lo, r_hi, n)
    pts = np.stack([center[0] + r * np.cos(angle),
                    center[1] + r * np.sin(angle)], axis=1)
    mask = np.ones(n, dtype=bool)
    for other in reject_centers:
        d = np.linalg.norm(pts - other[None], axis=1)
        mask &= d > (r if reject_r is None else reject_r)
    return pts[mask]


def synthesize_pose(joints: np.ndarray, area: float,
                    rng: np.random.Generator,
                    num_overlap: int = 0) -> np.ndarray:
    """Simulate detector output for a GT pose.

    joints: [17, 3] (x, y, valid). Returns [17, 3] synthesized pose. Per
    joint one of {jitter, miss, inversion, good} is sampled with the
    reference's probability tables (conditioned on #valid joints), with
    OKS-derived radii: jitter in the ks[0.85..0.5] annulus around GT, miss
    in ks[0.5..0.1], inversion within ks0.5 of the symmetric pair, good
    within ks0.85 of GT.
    """
    variances = (KPS_SIGMAS * 2) ** 2

    def ks_dist(ks):
        return np.sqrt(-2 * area * variances * np.log(ks))

    ks10, ks50, ks85 = ks_dist(0.10), ks_dist(0.50), ks_dist(0.85)
    synth = joints.copy().astype(np.float32)
    num_valid = int(np.sum(joints[:, 2] > 0))
    n_cand = 500

    for j in range(NUM_KPS):
        gt = synth[j, :2]
        pair = _pair_index(j)
        pair_valid = pair is not None and joints[pair, 2] > 0
        centers = [gt] + ([synth[pair, :2]] if pair_valid else [])

        # probability tables (reference: noise_utils.py:70-243)
        if num_valid <= 10:
            jitter_p = 0.15 if (j == 0 or 13 <= j <= 16) else (
                0.20 if 1 <= j <= 10 else 0.25)
        else:
            jitter_p = 0.10 if (j == 0 or 13 <= j <= 16) else (
                0.15 if 1 <= j <= 10 else 0.20)
        if num_valid <= 5:
            miss_p = 0.15 if j <= 4 else (
                0.20 if j in (5, 6, 15, 16) else 0.25)
        elif num_valid <= 10:
            miss_p = 0.10 if j <= 4 else (
                0.13 if j in (5, 6, 15, 16) else 0.15)
        else:
            miss_p = 0.02 if j <= 4 else (
                0.05 if j in (5, 6, 15, 16) else 0.10)
        inv_p = 0.01 if j <= 4 else (0.03 if 5 <= j <= 10 else 0.06)

        # candidate generation per error state
        others = lambda c: [o for o in centers if o is not c]  # noqa: E731
        jit = _sample_annulus(rng, gt, ks85[j], ks50[j], n_cand,
                              others(gt), None)
        miss_pts = []
        for idx, c in enumerate(centers):
            pts = _sample_annulus(rng, c, ks50[j], ks10[j], 4 * n_cand,
                                  others(c), ks50[j])
            if idx > 0 and len(pts):
                pts = pts[rng.choice(len(pts), size=len(pts) // 4)] \
                    if len(pts) >= 4 else pts[:0]
            miss_pts.append(pts)
        miss_pts = (np.concatenate(miss_pts) if miss_pts
                    else np.empty((0, 2)))
        inv = (_sample_annulus(rng, synth[pair, :2], 0, ks50[j], n_cand,
                               [gt], None)
               if pair_valid else np.empty((0, 2)))
        good = _sample_annulus(rng, gt, 0, ks85[j], n_cand // 4,
                               others(gt), None)

        cands = (jit, miss_pts, inv, good)
        probs = np.array([
            jitter_p if len(jit) else 0.0,
            miss_p if len(miss_pts) else 0.0,
            inv_p if len(inv) else 0.0,
        ])
        good_p = 1.0 - (jitter_p + miss_p + inv_p)
        probs = np.append(probs, good_p if len(good) else 0.0)
        z = probs.sum()
        if z == 0:
            synth[j] = 0
            continue
        state = rng.choice(4, p=probs / z)
        pts = cands[state]
        pick = pts[rng.integers(len(pts))]
        synth[j, :2] = pick
        synth[j, 2] = 1
    return synth


# per-joint probability tables, indexed by joint (reference:
# noise_utils.py:70-243 — conditioned on the number of valid joints)
def _table(vals_head, vals_mid, vals_tail, mid_idx, head_idx):
    t = np.full(NUM_KPS, vals_tail, np.float32)
    t[list(mid_idx)] = vals_mid
    t[list(head_idx)] = vals_head
    return t


_JIT_LOW = _table(.15, .20, .25, range(1, 11), [0, 13, 14, 15, 16])
_JIT_HIGH = _table(.10, .15, .20, range(1, 11), [0, 13, 14, 15, 16])
_MISS_LOW = _table(.15, .20, .25, [5, 6, 15, 16], range(0, 5))
_MISS_MID = _table(.10, .13, .15, [5, 6, 15, 16], range(0, 5))
_MISS_HIGH = _table(.02, .05, .10, [5, 6, 15, 16], range(0, 5))
_INV_P = _table(.01, .03, .06, range(5, 11), range(0, 5))
_PAIR = np.array([(_pair_index(j) if _pair_index(j) is not None else -1)
                  for j in range(NUM_KPS)], np.int64)


def _annulus_batch(rng, centers, r_lo, r_hi, k, reject, reject_r):
    """K candidates per row, uniform in the [r_lo, r_hi] annulus around
    centers [B, 2]; reject = [(other [B,2], other_valid [B])] rejects
    points within reject_r (or the point's own radius when None) of the
    other centers. Returns (pts [B,K,2], accept [B,K])."""
    b = centers.shape[0]
    ang = rng.uniform(0, 2 * np.pi, (b, k))
    r = (rng.uniform(size=(b, k)) * (r_hi - r_lo)[:, None]
         + r_lo[:, None])
    pts = centers[:, None, :] + np.stack(
        [r * np.cos(ang), r * np.sin(ang)], axis=-1)
    mask = np.ones((b, k), bool)
    for other, ovalid in reject:
        d = np.linalg.norm(pts - other[:, None, :], axis=-1)
        rr = r if reject_r is None else reject_r[:, None]
        mask &= np.where(ovalid[:, None], d > rr, True)
    return pts.astype(np.float32), mask


def _pick_accepted(rng, pts, mask):
    """Uniform pick among each row's accepted candidates -> (pt [B,2],
    ok [B])."""
    cnt = mask.sum(-1)
    u = rng.uniform(size=len(cnt))
    m = np.minimum((u * np.maximum(cnt, 1)).astype(np.int64),
                   np.maximum(cnt - 1, 0))
    csum = np.cumsum(mask, axis=-1)
    sel = np.argmax(csum == (m + 1)[:, None], axis=-1)
    return pts[np.arange(len(cnt)), sel], cnt > 0


def synthesize_pose_batch(joints: np.ndarray, areas: np.ndarray,
                          rng: np.random.Generator,
                          k: int = 256, k_miss: int = 512) -> np.ndarray:
    """Batched `synthesize_pose`: joints [B, 17, 3], areas [B] ->
    [B, 17, 3].

    Same per-joint state machine and radii as the scalar form, vectorized
    over the batch; joints are still processed IN ORDER so a joint's
    rejection/inversion centers see earlier joints' already-synthesized
    positions, exactly like the scalar loop. The miss state picks its
    center with weight floor(n_pair/4) against n_gt, matching the scalar
    form's floor(n/4)-element resample (a uniform pick among a
    with-replacement resample is uniform over the accepted points, so the
    weights match in distribution). Remaining documented deviation,
    confined to a rare event: candidate counts are k=256 / k_miss=512 per
    state vs the scalar's 125-2000, which only changes the probability of
    the zero-accepted fallback state.
    """
    b = joints.shape[0]
    variances = (KPS_SIGMAS * 2) ** 2

    def ks_dist(ks):
        return np.sqrt(-2 * areas[:, None] * variances[None]
                       * np.log(ks)).astype(np.float32)

    ks10, ks50, ks85 = ks_dist(0.10), ks_dist(0.50), ks_dist(0.85)
    synth = joints.copy().astype(np.float32)
    num_valid = (joints[:, :, 2] > 0).sum(1)
    ones = np.ones(b, bool)
    zeros_r = np.zeros(b, np.float32)

    for j in range(NUM_KPS):
        gt = synth[:, j, :2].copy()
        pair = int(_PAIR[j])
        if pair >= 0:
            pair_valid = joints[:, pair, 2] > 0
            pair_pos = synth[:, pair, :2]
        else:
            pair_valid = np.zeros(b, bool)
            pair_pos = np.zeros((b, 2), np.float32)

        jitter_p = np.where(num_valid <= 10, _JIT_LOW[j], _JIT_HIGH[j])
        miss_p = np.select([num_valid <= 5, num_valid <= 10],
                           [_MISS_LOW[j], _MISS_MID[j]], _MISS_HIGH[j])
        inv_p = np.full(b, _INV_P[j], np.float32)

        jit_pt, jit_ok = _pick_accepted(rng, *_annulus_batch(
            rng, gt, ks85[:, j], ks50[:, j], k,
            [(pair_pos, pair_valid)], None))
        good_pt, good_ok = _pick_accepted(rng, *_annulus_batch(
            rng, gt, zeros_r, ks85[:, j], k,
            [(pair_pos, pair_valid)], None))
        inv_pt, inv_ok = _pick_accepted(rng, *_annulus_batch(
            rng, pair_pos, zeros_r, ks50[:, j], k, [(gt, ones)], None))
        inv_ok &= pair_valid

        mg_pts, mg_m = _annulus_batch(
            rng, gt, ks50[:, j], ks10[:, j], k_miss,
            [(pair_pos, pair_valid)], ks50[:, j])
        mp_pts, mp_m = _annulus_batch(
            rng, pair_pos, ks50[:, j], ks10[:, j], k_miss, [(gt, ones)],
            ks50[:, j])
        mp_m &= pair_valid[:, None]
        n_g = mg_m.sum(-1)
        n_p = mp_m.sum(-1)
        # scalar form resamples floor(n/4) of the pair-centered points and
        # concatenates with the gt-centered ones before a uniform pick
        # (reference: noise_utils.py miss branch) -> weight floor(n_p/4)
        w_p = np.floor(n_p / 4.0)
        total = n_g + w_p
        take_pair = (rng.uniform(size=b) * np.maximum(total, 1e-9)) < w_p
        mg_pt, _ = _pick_accepted(rng, mg_pts, mg_m)
        mp_pt, _ = _pick_accepted(rng, mp_pts, mp_m)
        miss_pt = np.where(take_pair[:, None], mp_pt, mg_pt)
        miss_ok = total > 0

        good_p = 1.0 - (jitter_p + miss_p + inv_p)
        probs = np.stack([jitter_p * jit_ok, miss_p * miss_ok,
                          inv_p * inv_ok, good_p * good_ok], axis=-1)
        z = probs.sum(-1)
        u = rng.uniform(size=b) * np.maximum(z, 1e-12)
        state = np.minimum((u[:, None] >= np.cumsum(probs, -1)).sum(-1), 3)
        cand = np.stack([jit_pt, miss_pt, inv_pt, good_pt], axis=1)
        chosen = cand[np.arange(b), state]
        dead = z <= 0
        synth[:, j, :2] = np.where(dead[:, None], 0.0, chosen)
        synth[:, j, 2] = np.where(dead, 0.0, 1.0)
    return synth
