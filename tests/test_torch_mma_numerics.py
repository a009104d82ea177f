"""The numerical contract of the tensor-core kernels (csrc/mma.cuh), on the
CPU, and the host-side launch arithmetic of K3, K4's row launches and K5.

- f32 runs as "3xTF32": each operand x is cut into hi = tf32(x) and
  lo = tf32(x - hi), rounded as `cvt.rna.tf32.f32` rounds (to nearest,
  ties away from zero, 10 mantissa bits), and a*b is taken as
  lo_a*hi_b + hi_a*lo_b + hi_a*hi_b. Emulated here, the products come
  within 1e-6 (relative) of f32 at K3's and K4's shapes; a single TF32
  pass does not. The emulation sums each mma chain exactly and rounds it
  once: it leaves out the rounding inside the tensor cores' f32
  accumulator, so it covers the split, not the sums. That rounding grows
  with the chain (over lbf_wgrad's 5,568 rows in one chain, K4's scaled
  f32 gradient error reached 5.3e-5 on the card, against its bar of
  1e-4), which is why lbf_wgrad adds 64-row chains in f32 registers, as
  `mm_3xtf32(chunk=64)` models; the card checks at 1e-4 are what hold
  the accumulation.
- bf16 operands (rounded to nearest even, as the kernels round them)
  multiply exactly in f32: the tensor cores' products are bit-equal to the
  FMA chain's, and only the order of the sums differs.
"""
import importlib

import numpy as np
import pytest
import torch

# the modules (the package exports functions of the same names)
k3 = importlib.import_module("gator_tpu_torch.nn.fused_attention")
k4 = importlib.import_module("gator_tpu_torch.nn.lbf_stack_train")
k5 = importlib.import_module("gator_tpu_torch.nn.gat_trunk_train")
profile_attention = importlib.import_module(
    "gator_tpu_torch.tools.profile_attention")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, keeping 10 of the 23 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    # the magnitude bits plus half an ulp of TF32, then truncated: a tie
    # goes away from zero whatever the sign
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def split3(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, chunk: int = 0
              ) -> torch.Tensor:
    """a @ b as the kernels form it in f32: three TF32 products per mma
    chain of `chunk` terms (all of them when 0), the chain's sum taken
    exactly (a TF32 product fits in f64) and rounded to f32 once, the
    chains added in f32. The rounding inside a chain is left out."""
    ah, al = split3(a)
    bh, bl = split3(b)
    k = a.shape[1]
    step = chunk or k
    out = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, k, step):
        s = slice(c, c + step)
        out = out + (al[:, s].double() @ bh[s].double()
                     + ah[:, s].double() @ bl[s].double()
                     + ah[:, s].double() @ bh[s].double()).float()
    return out


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def _randn(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10                      # TF32 ulp at 1
    cases = {1.0 + ulp / 2: 1.0 + ulp,   # a tie rounds away from zero
             -(1.0 + ulp / 2): -(1.0 + ulp),
             1.0 + ulp / 2 - 2 ** -23: 1.0,
             1.0 + 1.5 * ulp: 1.0 + 2 * ulp,
             3.0: 3.0}
    for x, want in cases.items():
        got = tf32_rna(torch.tensor([x], dtype=torch.float32)).item()
        assert got == want, (x, got, want)
    x = _randn(0, 10000)
    hi = tf32_rna(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11 + 1e-38).all()
    assert torch.equal(tf32_rna(one), one)


def test_split_keeps_the_value_to_2_pow_minus_22():
    x = _randn(1, 100000) * 10
    hi, lo = split3(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -21).all()


# (M, K, N, mma chain) of the products: K3's scores and PV per warp (16
# query rows, D = 32, 64-key tiles), K4's row-tile products (16 rows: q,
# proj, fc1, fc2, the stacked dq2/dk2/dv2 backward, the cross-attention
# over 32 padded joints), each one chain, and a weight gradient over one
# lbf_wgrad chunk (5568 rows) in chains of 64 rows added in f32; K2's row
# launch (csrc/lbf_layer.cuh, 16 rows) takes fc2's K=256 as four chains
# of 64 (one [64, 64] weight block each) added in f32, and its
# self-attention's epilogue a [64, 64] tile through L3. K5 (32-row
# tiles) keeps a product's sum in one accumulator across its [64, 64]
# weight panels: fc2 over the 512 hidden units, the backward's dy over
# dqkv, dh0 M and dh1 M (384 + 128 + 128); its weight gradients sum one
# gat_block_wgrad chunk at B=512, J=17 (1,088 rows) in 64-row chains
SHAPES = {
    "k5_fc2": (32, 512, 128, 0), "k5_dy": (32, 640, 128, 0),
    "k5_wgrad": (64, 1088, 64, 64),
    "k2_rows_fc2": (16, 256, 64, 64), "k2_l3": (64, 64, 64, 0),
    "k3_scores": (16, 32, 64, 0), "k3_pv": (16, 64, 32, 0),
    "k3_scores_d64": (16, 64, 64, 0),
    "k4_q": (16, 64, 64, 0), "k4_fc1": (16, 64, 256, 0),
    "k4_fc2": (16, 256, 64, 0), "k4_dy3": (16, 192, 64, 0),
    "k4_cross": (16, 32, 32, 0), "k4_wgrad": (64, 5568, 64, 64),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_3xtf32_products_come_within_1e6_of_f32(shape):
    m, k, n, chunk = SHAPES[shape]
    a, b = _randn(2, m, k), _randn(3, k, n)
    exact = a.double() @ b.double()
    f32 = a @ b
    got = mm_3xtf32(a, b, chunk)
    # as close to exact as an f32 product, and within 1e-6 of it
    assert rel(got, f32) <= 1e-6
    assert rel(got, exact) <= 2 * max(rel(f32, exact), 1e-7)
    # one TF32 pass keeps about three decimal digits: not enough for 1e-4
    one = (tf32_rna(a).double() @ tf32_rna(b).double()).float()
    assert rel(one, exact) > 10 * rel(got, exact)


def test_3xtf32_each_product_within_1e6():
    a, b = _randn(4, 100000), _randn(5, 100000)
    ah, al = split3(a)
    bh, bl = split3(b)
    prod = (al.double() * bh.double() + ah.double() * bl.double()
            + ah.double() * bh.double())
    exact = a.double() * b.double()
    assert ((prod - exact).abs() <= exact.abs() * 1e-6).all()


@pytest.mark.parametrize("seed", [6, 7])
def test_bf16_products_are_exact_in_f32(seed):
    """rnd(a) * rnd(b) in f32 equals the exact product, so the tensor
    core's product equals the FMA chain's (fmaf(rnd(a), rnd(b), s) adds the
    exact product); the sums alone may differ in order."""
    a = _randn(seed, 200000).to(torch.bfloat16).float() * 37
    b = _randn(seed + 1, 200000).to(torch.bfloat16).float()
    assert torch.equal((a * b).double(), a.double() * b.double())
    # and a K4 row product differs from the f64 sum only by f32 sums
    x = _randn(seed, 16, 256).to(torch.bfloat16).float()
    w = _randn(seed + 2, 256, 64).to(torch.bfloat16).float()
    assert rel(x @ w, x.double() @ w.double()) < 1e-6


def _qkv(b=2, nq=431, nk=431, h=2, d=32, dtype=torch.float32):
    return (torch.zeros(b, nq, h, d, dtype=dtype),
            torch.zeros(b, nk, h, d, dtype=dtype),
            torch.zeros(b, nk, h, d, dtype=dtype))


def test_attention_check_takes_the_kernels_shapes():
    for d in k3.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for nq, nk in ((431, 431), (1, 1), (17, 1000)):
                q, k, v = _qkv(nq=nq, nk=nk, d=d, dtype=dtype)
                k3._check(q, k, v, torch.zeros(2, nq, nk))
                k3._check(q, k, v, None)


REFUSED = {
    "no_keys": lambda: _qkv(nk=0) + (None,),
    "d24": lambda: _qkv(d=24) + (None,),
    "d128": lambda: _qkv(d=128, dtype=torch.bfloat16) + (None,),
    "f16": lambda: _qkv(dtype=torch.float16) + (None,),
    "mixed": lambda: _qkv()[:2] + (torch.zeros(2, 431, 2, 32,
                                               dtype=torch.bfloat16), None),
    "bias": lambda: _qkv() + (torch.zeros(2, 431, 430),),
    "nk_ne": lambda: _qkv()[:2] + (torch.zeros(2, 430, 2, 32), None),
    "samples": lambda: _qkv(b=65536, nq=1, nk=1, d=8) + (None,),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_attention_check_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        k3._check(*REFUSED[case]())


def test_profile_attention_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_attention.main([])


def test_rows_aligned_sends_misaligned_views_to_a_copy():
    qkv = torch.zeros(2, 431, 3, 2, 32)
    assert k3.rows_aligned(qkv[:, :, 1])
    odd = torch.zeros(2 * 431 * 2 * 32 + 1)[1:].view(2, 431, 2, 32)
    assert not k3.rows_aligned(odd)
    assert not k3.rows_aligned(torch.zeros(2, 431, 32, 2).transpose(2, 3))


@pytest.mark.parametrize("b,nv,wave", [(512, 431, 396), (512, 431, 264),
                                       (3, 50, 396), (1, 1, 396),
                                       (300, 50, 132), (64, 433, 396)])
def test_lbf_launch_plan_covers_every_row(b, nv, wave):
    plan = k4.launch_plan(b, nv, wave)
    tr = k4.ROW_TILE
    rows = b * nv
    assert plan["nrt"] * tr >= nv > (plan["nrt"] - 1) * tr
    assert plan["nc_rows"] == min(wave, b * plan["nrt"])
    assert plan["wper"] % k4.WGRAD_ROWS == 0
    assert plan["nc_w"] * plan["wper"] >= rows > (plan["nc_w"] - 1) * plan[
        "wper"]
    assert plan["nc_w"] <= k4.WGRAD_CHUNKS
    sa = k4.SA_TILE
    assert plan["nqt"] * sa >= nv > (plan["nqt"] - 1) * sa
    assert plan["nc_j"] == min(b, k4.NCTA_MAX)


@pytest.mark.parametrize("b,nv,wave", [(0, 431, 396), (4, 0, 396),
                                       (65536, 1, 396), (40000, 60000, 396),
                                       (4, 431, 0)])
def test_lbf_launch_plan_refuses_what_the_kernels_do_not_take(b, nv, wave):
    with pytest.raises(ValueError):
        k4.launch_plan(b, nv, wave)


@pytest.mark.parametrize("b", [1, 5, 512, 800, 65537])
@pytest.mark.parametrize("j", [1, 17, 19, 32])
def test_gat_launch_plan_takes_whole_samples_once(b, j):
    """K5's tiles: consecutive runs of whole samples, each sample in
    exactly one tile, at most TILE_ROWS rows a tile, a 1-D grid within the
    card's limit; gat_block_wgrad's chunks cover the B * J rows once."""
    plan = k5.launch_plan(b, j)
    g = plan["g"]
    assert g >= 1 and g * j <= k5.TILE_ROWS
    seen = np.zeros(b, dtype=np.int64)
    for t in range(plan["ntiles"]):
        first, last = t * g, min(b, t * g + g)
        assert first < last
        seen[first:last] += 1
    assert (seen == 1).all()
    assert 1 <= plan["ntiles"] <= k5.GRID_MAX
    assert plan["rows"] == b * j
    assert plan["wper"] % k5.WGRAD_ROWS == 0
    assert plan["nc_w"] <= k5.WGRAD_CHUNKS
    assert plan["nc_w"] * plan["wper"] >= b * j > (plan["nc_w"] - 1) * plan[
        "wper"]


@pytest.mark.parametrize("b,j", [(0, 17), (-1, 17), (4, 33), (4, 0)])
def test_gat_launch_plan_refuses_what_the_kernels_do_not_take(b, j):
    with pytest.raises(ValueError):
        k5.launch_plan(b, j)
