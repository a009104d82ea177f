"""The port's data-parallel helpers (gator_tpu_torch.parallel) on the CPU:

- `pad_to_multiple` and `local_rows` against gator_tpu.parallel's
  `pad_to_multiple` and `shard_batch` on a 3-device mesh, the error on
  mixed leading dims included;
- `init_world` without torchrun's variables is world 1 with no process
  group, and a rank without its card raises;
- `spawn` relays a rank's failure and kills every child at its time limit;
- K4's and K5's plain masks at sample0 = b equal rows [b, 2b) of the masks
  of a 2b batch, bit for bit, and sample0 = 0 is the one-device draw; the
  plain stacks export the masks of the rows they ran;
- the MDR head's BatchNorm statistics over 2 gloo ranks equal one
  process's on the joined batch: forward, input gradient and running
  stats to 1e-6.
"""
import time

import jax
import numpy as np
import pytest
import torch

from gator_tpu import parallel as jpar
from gator_tpu_torch import parallel
from gator_tpu_torch.nn import dropout_masks as dm
from gator_tpu_torch.nn.gat_trunk_train import (BlockCfg, block_masks,
                                                gat_trunk_train)
from gator_tpu_torch.nn.lbf_stack_train import (DEFAULT_RATES, LayerCfg,
                                                layer_masks, lbf_stack_train)
from gator_tpu_torch.parallel.checks import run_cases


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"pose2d": rng.normal(size=(n, 17, 2)).astype(np.float32),
            "row": np.arange(n, dtype=np.int64),
            "mesh": rng.normal(size=(n, 5, 3)).astype(np.float32)}


@pytest.mark.parametrize("n,multiple", [(7, 3), (6, 3), (1, 4), (5, 1)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = _batch(n)
    got, real = parallel.pad_to_multiple(batch, multiple)
    want, jreal = jpar.pad_to_multiple(batch, multiple)
    assert real == jreal == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
    # tensors pad the same way, and stay tensors
    tgot, _ = parallel.pad_to_multiple(
        {k: torch.from_numpy(v) for k, v in batch.items()}, multiple)
    for k in batch:
        assert isinstance(tgot[k], torch.Tensor)
        np.testing.assert_array_equal(tgot[k].numpy(), want[k])


def test_pad_to_multiple_refuses_mixed_leading_dims():
    bad = {"a": np.zeros((3, 2)), "b": np.zeros((4, 2))}
    with pytest.raises(ValueError, match="share the leading batch dim"):
        jpar.pad_to_multiple(bad, 2)
    with pytest.raises(ValueError, match="share the leading batch dim"):
        parallel.pad_to_multiple(bad, 2)


def test_local_rows_match_shard_batch():
    mesh = jpar.make_mesh(jax.devices()[:3])
    batch = _batch(9)
    sharded = jpar.shard_batch(mesh, batch)
    for rank in range(3):
        world = parallel.World(rank=rank, size=3)
        got = parallel.local_rows(batch, world)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == mesh.devices[rank])
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
    # a batch that does not divide over the ranks raises on both sides
    with pytest.raises(ValueError, match="does not divide"):
        parallel.local_rows(_batch(8), parallel.World(rank=0, size=3))
    with pytest.raises(ValueError):
        jpar.shard_batch(mesh, _batch(8))
    # world 1 (or none) is the identity
    assert parallel.local_rows(batch, parallel.single()) is batch
    assert parallel.local_rows(batch, None) is batch


def test_init_world_without_torchrun_and_without_a_card(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    world = parallel.init_world("cpu")
    assert (world.rank, world.size, world.grouped) == (0, 1, False)
    assert world.device == torch.device("cpu")
    # every collective is then the identity
    t = torch.ones(3)
    assert parallel.all_gather_rows(t, world) is t
    assert parallel.any_rank(True, world) and not parallel.any_rank(
        False, world)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="needs a card of its own"):
            parallel.init_world("cuda")


def test_spawn_relays_a_failure_and_kills_at_its_time_limit():
    bad = {"kind": "bn", "x": np.zeros((3, 2, 3), np.float32),
           "g": np.zeros((3, 2, 3), np.float32),
           "running": (np.zeros(2), np.ones(2))}
    with pytest.raises(RuntimeError, match="does not divide"):
        parallel.spawn(run_cases, 2, args=([bad],), timeout=60)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        # importing torch alone takes longer than this in a new process
        parallel.spawn(run_cases, 2, args=([],), timeout=0.5)
    assert time.monotonic() - t0 < 30


def test_plain_masks_take_the_sample_base():
    b, nv, nj, c, j = 3, 20, 17, 64, 17
    lcfg = LayerCfg(num_heads=2, layer=1, seed=41, rates=DEFAULT_RATES)
    whole = layer_masks(lcfg, 2 * b, nv, nj, c)
    first = layer_masks(lcfg, b, nv, nj, c)
    second = layer_masks(LayerCfg(num_heads=2, layer=1, seed=41,
                                  rates=DEFAULT_RATES, sample0=b),
                         b, nv, nj, c)
    gcfg = BlockCfg(num_heads=8, block=1, seed=77, path_rate=0.2)
    gwhole = block_masks(gcfg, 2 * b, j, 128)
    gsecond = block_masks(BlockCfg(num_heads=8, block=1, seed=77,
                                   path_rate=0.2, sample0=b), b, j, 128)
    for want, lo, got in [(whole, 0, first), (whole, b, second),
                          (gwhole, b, gsecond)]:
        assert set(got) == set(want)
        for k, m in want.items():
            assert torch.equal(got[k], m[lo:lo + b]), k
    bits = dm.mask_bits(5, 3, dm.M_OUT, 2 * b, 40)
    assert torch.equal(dm.mask_bits(5, 3, dm.M_OUT, b, 40, sample0=b),
                       bits[b:])


def _exports(fn, x, *args, sample0):
    got = []
    out = fn(x, *args, export=got, sample0=sample0)
    return out, got


def test_plain_stacks_export_the_masks_of_their_rows():
    """lbf_stack_train and gat_trunk_train on CPU tensors (their plain
    versions) at sample0 = b: the exported masks are rows [b, 2b) of a 2b
    batch's, bit for bit, and the output rows agree."""
    from test_torch_gat_trunk_train import _block_params
    from test_torch_lbf_stack_train import _params

    b = 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2 * b, 37, 64)).astype(np.float32))
    jt = torch.from_numpy(rng.normal(size=(2 * b, 5, 64)).astype(np.float32))
    layers = [{k: torch.from_numpy(v) for k, v in _params(s).items()}
              for s in range(2)]
    whole, wm = _exports(lbf_stack_train, x, jt, layers, 2, 7,
                         sample0=0)
    part, pm = _exports(lbf_stack_train, x[b:], jt[b:], layers, 2, 7,
                        sample0=b)
    gx = torch.from_numpy(rng.normal(size=(2 * b, 17, 64)).astype(
        np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, (4, 17, 17)).astype(
        np.float32))
    xm = (rng.uniform(size=(2, 17, 17)) < 0.4).astype(np.float32)
    blocks = [{k: torch.from_numpy(v) for k, v in _block_params(s).items()}
              for s in range(2)]
    gwhole, gwm = _exports(gat_trunk_train, gx, bias, blocks, xm, 4, 7,
                           sample0=0)
    gpart, gpm = _exports(gat_trunk_train, gx[b:], bias, blocks, xm, 4, 7,
                          sample0=b)
    for w_out, p_out, w_masks, p_masks in ((whole, part, wm, pm),
                                           (gwhole, gpart, gwm, gpm)):
        np.testing.assert_allclose(p_out.numpy(), w_out[b:].numpy(),
                                   atol=1e-5, rtol=0)
        assert len(p_masks) == len(w_masks) == 2
        for got, want in zip(p_masks, w_masks):
            for k, m in want.items():
                if m is None:
                    assert got[k] is None, k
                else:
                    assert torch.equal(got[k], m[b:]), k


def test_batchnorm_over_two_ranks_equals_one_process():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 32, 3)) * 0.7 + 0.3).astype(np.float32)
    case = {"kind": "bn", "x": x,
            "g": rng.normal(size=x.shape).astype(np.float32),
            "running": (rng.normal(size=32).astype(np.float32),
                        rng.uniform(0.5, 2, size=32).astype(np.float32))}
    want = run_cases(None, [case])[0]
    ranks = parallel.spawn(run_cases, 2, args=([case],), timeout=60)
    for key in ("y", "dx"):
        got = np.concatenate([r[0][key] for r in ranks])
        np.testing.assert_allclose(got, want[key],
                                   atol=1e-6, rtol=0, err_msg=key)
    for r in ranks:
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[0][key],
                                       want[key],
                                       atol=1e-6, rtol=0, err_msg=key)
