"""The port's device detector-noise simulators (data/device_noise.py)
against the JAX package's (gator_tpu/data/device_noise.py), on the CPU.

Fed the JAX function's own uniforms in the JAX key schedule, the port's
`synthesize_pose_device` computes the same function: every (row, joint)
within 1e-3 px, except at most 0.2 % boundary cases, each shown to be one
(a candidate within 1e-3 px of its acceptance radius, a state uniform
within 1e-6 of a cumulative-probability edge, or its symmetric pair such
a case in the wave before; chip_smoke.noise_same_draws, which phase 26
shares). XLA's and torch's cos, sin and sums may differ by an ulp, which
moves such a draw across the edge.
`h36m_syn_error_device` from the same draws within 1e-6. With the port's
own generator, the simulator passes tests/test_device_noise.py's bars
against the JAX host `synthesize_pose_batch` at B=4096: per-joint band
frequencies within 0.035 (pooled 0.012) and the radius quantiles within
rtol 0.06, atol 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gator_tpu.data import device_noise as jdn
from gator_tpu.data import noise as jnoise
from gator_tpu.data import processing as jproc
from gator_tpu.data.device_pipeline import affine_crop as jaffine_crop
from gator_tpu.data.gt_synth import GtSynthesizer as JaxSynth
from gator_tpu.data.packed import build_packed_tables as jbuild
from gator_tpu.data.synthetic import synthetic_coco_dataset as jcoco
from gator_tpu_torch.data import device_noise as dn
from test_torch_readers import _chip_smoke
from test_torch_readers import one_torch_thread  # noqa: F401

H36M_NAMES = ("Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
              "L_Ankle", "Torso", "Neck", "Nose", "Head", "L_Shoulder",
              "L_Elbow", "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist")
B = 64
K, K_MISS = 256, 512
ANNULI = {1: K, 3: K, 5: K, 6: K_MISS, 7: K_MISS}     # ks index -> K
PICKS = {0: K, 2: K, 4: K, 9: K_MISS, 10: K_MISS}


def _pose_schedule(key, b):
    """Every uniform `synthesize_pose_device` draws, by path, in the JAX
    key schedule: per wave `fold_in(key, w)` then `split(., 12)`; an
    annulus splits its key into angle and radius keys."""
    out = {}
    for w, wave in enumerate((jdn._WAVE1, jdn._WAVE2)):
        ks = jax.random.split(jax.random.fold_in(key, w), 12)
        m = len(wave)
        for i, k in ANNULI.items():
            ka, kr = jax.random.split(ks[i])
            out[(w, i, 0)] = jax.random.uniform(ka, (b, m, k))
            out[(w, i, 1)] = jax.random.uniform(kr, (b, m, k))
        for i, k in PICKS.items():
            out[(w, i)] = jax.random.uniform(ks[i], (b, m, k))
        for i in (8, 11):
            out[(w, i)] = jax.random.uniform(ks[i], (b, m))
    return out


def _h36m_schedule(key, b, j):
    kn, kk = jax.random.split(key)
    return {(0,): jax.random.normal(kn, (b, j, 2)),
            (1,): jax.random.uniform(kk, (b, j))}


class TableDraws(dn.Draws):
    """The port's draw interface over a table of the JAX draws; records
    the order of the paths asked for."""

    def __init__(self, table):
        self.table = {k: np.asarray(v) for k, v in table.items()}
        self.asked = []

    def _get(self, path, shape):
        self.asked.append(path)
        got = self.table[path]
        assert got.shape == tuple(shape), (path, got.shape, shape)
        return torch.from_numpy(got.copy())

    uniform = normal = _get


@pytest.fixture(scope="module")
def shared():
    """Crop-space poses, areas, the JAX draws, the JAX output and the
    port's output from those draws."""
    rng = np.random.default_rng(0)
    joints = np.asarray(rng.uniform(60, 230, (B, 17, 2)), np.float32)
    # a range of person sizes, the smallest crowding the pair rejections
    areas = np.asarray(rng.uniform(3000, 80000, B), np.float32)
    key = jax.random.PRNGKey(3)
    table = jax.jit(_pose_schedule, static_argnums=1)(key, B)
    want = np.asarray(jax.jit(jdn.synthesize_pose_device)(
        key, jnp.asarray(joints), jnp.asarray(areas)))
    draws = TableDraws(table)
    got = dn.synthesize_pose_device(draws, torch.from_numpy(joints),
                                    torch.from_numpy(areas)).numpy()
    return joints, areas, draws, want, got


def test_same_draws_same_function(shared, capsys):
    """chip_smoke.noise_same_draws's rule (phase 26 holds the card to the
    CPU with it)."""
    joints, areas, draws, want, got = shared
    assert got.shape == want.shape == (B, 17, 2)
    off, explained, rest = _chip_smoke().noise_same_draws(
        joints, areas, draws.table, got, want)
    with capsys.disabled():
        print(f"\nshared draws: {off} of {B * 17} (row, joint) beyond 1e-3 "
              f"px, {explained} of them boundary cases; the rest within "
              f"{rest:.2e} px")


def test_two_wave_order_kept(shared):
    """The waves are the JAX package's, wave 1's draws all come before
    wave 2's, and wave 2 reads wave 1's output (a pair is always in the
    other wave or absent)."""
    draws = shared[2]
    np.testing.assert_array_equal(dn._WAVE1, jdn._WAVE1)
    np.testing.assert_array_equal(dn._WAVE2, jdn._WAVE2)
    waves = [p[0] for p in draws.asked]
    assert waves == sorted(waves) and set(waves) == {0, 1}
    assert len(draws.asked) == len(draws.table)
    for j in dn._WAVE2:
        assert jnoise._PAIR[j] in dn._WAVE1
    for j in dn._WAVE1:
        assert jnoise._PAIR[j] < 0 or jnoise._PAIR[j] in dn._WAVE2


def test_all_rejected_row_picks_index_0():
    """jnp.argmax's rule on an all-masked row: index 0."""
    pts = torch.arange(2 * 3 * 5 * 2, dtype=torch.float32).reshape(
        2, 3, 5, 2)
    mask = torch.zeros(2, 3, 5, dtype=torch.bool)
    mask[0, 1, 3] = True

    class Const(dn.Draws):
        def uniform(self, path, shape):
            return torch.full(tuple(shape), 0.5)

    pt, ok = dn._pick(Const(), (0, 0), (pts[..., 0], pts[..., 1]), mask)
    want = pts[:, :, 0].clone()
    want[0, 1] = pts[0, 1, 3]
    assert torch.equal(pt, want)
    assert ok.tolist() == [[False, True, False], [False, False, False]]


def test_h36m_error_same_draws():
    stats = jnoise.h36m_error_stats(H36M_NAMES)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jdn.h36m_syn_error_device(key, stats, B, (384, 288)))
    draws = TableDraws(_h36m_schedule(key, B, 17))
    got = dn.h36m_syn_error_device(draws, torch.from_numpy(stats), B,
                                   (384, 288)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def crop_pose_batch(small_assets_coco):
    """tests/test_device_noise.py's poses: the synthetic COCO dataset's
    input joints through the affine crop, with their OKS areas, tiled to
    B=4096."""
    synth = JaxSynth(small_assets_coco)
    opts = jproc.ProcessOptions(is_train=True, use_gt_input=False,
                                input_joint_name="coco")
    ds = jcoco(small_assets_coco, opts, n=64, seed=0, synthesizer=synth)
    jbuild([ds], synth, chunk=16)
    img = ds._packed.joint_img_input
    crop = np.asarray(jaffine_crop(
        jnp.asarray(img, jnp.float32), opts.input_shape,
        jnp.zeros(len(img), jnp.float32)))[:, :17]
    areas = jproc.crop_area_batch(img, opts)
    reps = 4096 // len(crop)
    return (np.tile(crop, (reps, 1, 1)).astype(np.float32),
            np.tile(areas, reps).astype(np.float32))


def _band_freqs(out, gt, areas):
    """[17, 3] frequencies of the radius bands: good r <= ks85, jitter
    ks85 < r <= ks50, far r > ks50 (miss and inversion)."""
    var = (jnoise.KPS_SIGMAS * 2) ** 2
    r = np.linalg.norm(out - gt, axis=-1)
    ks85 = np.sqrt(-2.0 * areas[:, None] * var[None] * np.log(0.85))
    ks50 = np.sqrt(-2.0 * areas[:, None] * var[None] * np.log(0.50))
    return np.stack([(r <= ks85).mean(0), ((r > ks85) & (r <= ks50)).mean(0),
                     (r > ks50).mean(0)], axis=1)


def test_own_generator_matches_host_distribution(crop_pose_batch):
    joints, areas = crop_pose_batch
    host = jnoise.synthesize_pose_batch(
        np.concatenate([joints, np.ones_like(joints[..., :1])], axis=-1),
        areas, np.random.default_rng(7))[:, :, :2]
    dev = dn.synthesize_pose_device(
        torch.Generator().manual_seed(7), torch.from_numpy(joints),
        torch.from_numpy(areas)).numpy()
    fh, fd = _band_freqs(host, joints, areas), _band_freqs(dev, joints,
                                                           areas)
    np.testing.assert_allclose(fd, fh, rtol=0, atol=0.035)
    np.testing.assert_allclose(fd.mean(0), fh.mean(0), rtol=0, atol=0.012)
    good_p = 1.0 - (jnoise._JIT_HIGH + jnoise._MISS_HIGH + jnoise._INV_P)
    assert (fd[:, 0] >= good_p - 0.04).all()
    assert (fd[:, 2] >= jnoise._MISS_HIGH - 0.04).all()

    var = (jnoise.KPS_SIGMAS * 2) ** 2
    scale = np.sqrt(areas[:, None] * var[None])
    qs = [0.25, 0.5, 0.75, 0.9]
    qh = np.quantile((np.linalg.norm(host - joints, axis=-1)
                      / scale).ravel(), qs)
    qd = np.quantile((np.linalg.norm(dev - joints, axis=-1)
                      / scale).ravel(), qs)
    np.testing.assert_allclose(qd, qh, rtol=0.06, atol=0.02)
    # reproducible from the generator's seed, and another seed differs
    again = dn.synthesize_pose_device(
        torch.Generator().manual_seed(7), torch.from_numpy(joints[:64]),
        torch.from_numpy(areas[:64])).numpy()
    other = dn.synthesize_pose_device(
        torch.Generator().manual_seed(8), torch.from_numpy(joints[:64]),
        torch.from_numpy(areas[:64])).numpy()
    np.testing.assert_array_equal(again, dn.synthesize_pose_device(
        torch.Generator().manual_seed(7), torch.from_numpy(joints[:64]),
        torch.from_numpy(areas[:64])).numpy())
    assert np.abs(other - again).max() > 1e-3
