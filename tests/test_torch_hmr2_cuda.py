"""HMR 2.0's serving path on a card: K3 at the backbone's 80-wide heads
(192 patch tokens) and at the decoder's cross-attention (one query against
192 keys) against its plain version; K3's outputs at the head widths it
took before 80 against their recorded digests; the served crops against
the plain float32 reference at the published widths and against the same
call on plain attention; K3's launches a call by kernel and head width.
Skips without a card.

This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_hmr2_cuda.py
Bars: K3 as tests/test_torch_eval_kernels_cuda.py (f32 atol 1e-4, bf16
5e-2: sums in another order can flip a bf16 rounding of a probability);
the digests are bit-equality with the kernels before D = 80 was added
(`EARLIER_DIGESTS`, read from gator_tpu_torch/tools/profile_attention.py
`head_width_digests` on the tree before it); the served crops held to
the cell's own limits (benchmark/traffic/serve-crop-b64.json), and on K3
against the same call on plain attention (gaps as shares of the crops'
RMS spread, as test_torch_motionbert_cuda.py holds the clips: f32 1e-3 /
2e-3 / 1e-3, bf16 0.2 / 0.3 / 0.2), with a planted fault in the
backbone's attention (each crop's output written into the next crop's)
that the bf16 bars must see.
"""
import pytest
import torch

from gator_tpu_torch.models import hmr2
from gator_tpu_torch.nn.fused_attention import (fused_attention,
                                                fused_attention_into,
                                                fused_attention_ref,
                                                route)
from gator_tpu_torch.serving import make_serving_fn
from gator_tpu_torch.tools.profile_attention import head_width_digests
from torch_fixtures import launched, only

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
CELL = ("hmr2-vith16-256x192", "serve-crop-b64")
# head_width_digests()'s cases run over the tree before K3 took D = 80
# (its package first on sys.path, the same seeded inputs; an H100),
# equal to this tree's own output in the same run
EARLIER_DIGESTS = {
    "tiled_d8_bfloat16": "82b278f2b4491e32",
    "tiled_q1_d8_bfloat16": "a7ed393e1df48922",
    "short_d8_bfloat16": "df5dd26f10fe243c",
    "tiled_d16_bfloat16": "29594e6c9ee66380",
    "tiled_q1_d16_bfloat16": "f06ac63f3102a718",
    "short_d16_bfloat16": "2a3c38ca31c4bafb",
    "tiled_d32_bfloat16": "8b0aecbbf17f2028",
    "tiled_q1_d32_bfloat16": "305247764d584fba",
    "short_d32_bfloat16": "ef1ffb7f89f68bdf",
    "tiled_d64_bfloat16": "c7fcece3b354f7cd",
    "tiled_q1_d64_bfloat16": "93dc72440db7436c",
    "short_d64_bfloat16": "5b640fbdf853c250",
    "tiled_d8_float32": "9f748e6a217dc184",
    "tiled_q1_d8_float32": "d882adf8c7f0d21c",
    "short_d8_float32": "56156345b1c37657",
    "tiled_d16_float32": "036a9219aabd761c",
    "tiled_q1_d16_float32": "1cc1340be2b333bf",
    "short_d16_float32": "6a54ea71a5d8829e",
    "tiled_d32_float32": "75319d47727ae718",
    "tiled_q1_d32_float32": "93234c56a867f8bd",
    "short_d32_float32": "49687c729693d987",
    "tiled_d64_float32": "2fa7c61f13bca6f3",
    "tiled_q1_d64_float32": "0e471b7a294a9151",
    "short_d64_float32": "8e6c60d4c4954542"}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counted(fn):
    """fn() -> (its result, the K3 launches it made: in all, short, by
    head width)."""
    before = (fused_attention.launches, fused_attention.short_launches,
              dict(fused_attention.launches_by_dim),
              dict(fused_attention.short_launches_by_dim))
    got = fn()
    torch.cuda.synchronize()
    by = {d: n - before[2].get(d, 0)
          for d, n in fused_attention.launches_by_dim.items()
          if n != before[2].get(d, 0)}
    short_by = {d: n - before[3].get(d, 0)
                for d, n in fused_attention.short_launches_by_dim.items()
                if n != before[3].get(d, 0)}
    return got, (fused_attention.launches - before[0],
                 fused_attention.short_launches - before[1], by, short_by)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_vit_80_wide_heads(card, dtype):
    """The backbone's attention: [64 crops, 192, 16, 80] views of one qkv
    product, on the tiled kernel, counted at D = 80."""
    gen = torch.Generator(device=card).manual_seed(80)
    qkv = torch.randn(64, 192, 3, 16, 80, generator=gen,
                      device=card).to(dtype)
    q, k, v = qkv.unbind(2)
    assert route(192, 192) == "tiled"
    with torch.no_grad():
        got, counts = _counted(lambda: fused_attention_into(q, k, v,
                                                            80 ** -0.5))
    assert counts == (1, 0, {80: 1}, {})
    want = fused_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, 80 ** -0.5)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 17, 63, 64, 65, 192, 431])
def test_k3_80_wide_heads_at_tile_edges(card, dtype, n):
    """D = 80 on both kernels (the short-row one up to 32 tokens), with a
    bias, at key counts across the 64-key tile."""
    gen = torch.Generator(device=card).manual_seed(n)
    q, k, v = (torch.randn(5, n, 3, 80, generator=gen, device=card)
               .to(dtype) for _ in range(3))
    bias = torch.randn(3, n, n, generator=gen, device=card)
    for b in (None, bias):
        with torch.no_grad():
            got, counts = _counted(lambda: fused_attention(q, k, v, b, 0.11))
        short = route(n, n) == "short"
        assert counts == (1, int(short), {80: 1}, {80: 1} if short else {})
        want = fused_attention_ref(q, k, v, b, 0.11)
        assert (got.float() - want.float()).abs().max().item() <= \
            TOL[dtype], (n, b is None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_cross_attention_one_query(card, dtype):
    """The decoder's cross-attention: one query [64, 1, 8, 64] against the
    k and v views of one [64, 192, layer, k|v, 8, 64] product."""
    gen = torch.Generator(device=card).manual_seed(64)
    q = torch.randn(64, 1, 8, 64, generator=gen, device=card).to(dtype)
    kv = torch.randn(64, 192, 6, 2, 8, 64, generator=gen,
                     device=card).to(dtype)
    k, v = kv[:, :, 3, 0], kv[:, :, 3, 1]
    with torch.no_grad():
        got, counts = _counted(lambda: fused_attention_into(q, k, v, 0.125))
    assert counts == (1, 0, {64: 1}, {})
    want = fused_attention_ref(q, k.contiguous(), v.contiguous(), None,
                               0.125)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_earlier_head_widths_keep_their_bits(card):
    """K3 at D = 8, 16, 32 and 64 on both kernels gives the bits it gave
    before D = 80 was added."""
    got = head_width_digests()
    assert set(got) == set(EARLIER_DIGESTS)
    assert got == EARLIER_DIGESTS


def _cell_model(card, seed):
    from benchmark.core import spec
    drv = spec.driver("serve_crops")
    cfg, mix = spec.config(CELL[0]), spec.traffic(CELL[1])
    assets, model, w = drv.build_model(cfg, card, seed, torch.bfloat16)
    return drv, cfg, mix, assets, model, w


@pytest.mark.cuda
def test_served_crops_match_the_reference(card):
    """The cell's own parts at B = 8 crops: the port's serving call
    against the plain float32 reference, within the cell's limits, with
    44 K3 launches a call: 32 at D = 80 (the backbone), 12 at D = 64 (the
    decoder), 6 of those on the short-row kernel."""
    from benchmark.core import check
    from benchmark.reference import hmr2 as ref
    seed = 2**31 + 13
    drv, cfg, mix, assets, model, w = _cell_model(card, seed)
    serve = drv.make_program(model, torch.bfloat16)
    x = drv.make_pool(seed, 1, 8, cfg, card)[0]
    out, counts = _counted(lambda: serve(x))
    assert counts == (44, 6, {80: 32, 64: 12}, {64: 6})
    assert out[0].shape == (8, 6890, 3) and out[0].dtype == torch.float32
    assert out[1].shape == (8, 24, 3) and out[2].shape == (8, 3)
    values = drv.compare([out], [x], w, ref.tables_of(assets, card), cfg, 8)
    ok, checks = check.judge(values, mix["limits"])
    assert ok, checks


def _rms(z):
    return float(z.double().pow(2).mean().sqrt())


CROP_BARS = {torch.float32: {"mesh_rel_rms": 1e-3,
                             "mesh_row_rel_rms_max": 2e-3,
                             "joints_rel_rms": 1e-3},
             torch.bfloat16: {"mesh_rel_rms": 0.2,
                              "mesh_row_rel_rms_max": 0.3,
                              "joints_rel_rms": 0.2}}


@pytest.mark.cuda
def test_served_crops_on_k3_match_the_plain_path(card, monkeypatch,
                                                 record_property):
    """64 crops at the published widths served through `make_serving_fn`
    in f32 and bf16, on K3 against the same call with use_kernels=False.
    The gaps are shares of what the crops decide: the plain f32 call's RMS
    distance from its mean over the crops. The planted fault, each crop's
    backbone attention output written into the next crop's, must read
    outside every bf16 bar. The bf16 call launches K3 44 times and no
    other hand kernel. The gaps go to the JUnit report (`--junitxml`) as
    properties."""
    f32, bf16 = torch.float32, torch.bfloat16
    drv, cfg, mix, assets, model, w = _cell_model(card, 2**31 + 17)
    x = drv.make_pool(5, 1, 64, cfg, card)[0]
    with launched() as counts:
        got = {bf16: make_serving_fn(model, bf16)(x)}
    only(counts, fused_attention=44)
    got[f32] = make_serving_fn(model, f32)(x)
    ref = {dt: make_serving_fn(model, dt, use_kernels=False)(x)
           for dt in (f32, bf16)}
    ref_v, ref_j, _ = ref[f32]
    spread_v = _rms(ref_v - ref_v.mean(0, keepdim=True))
    spread_j = _rms(ref_j - ref_j.mean(0, keepdim=True))
    assert spread_v > 1e-3, spread_v

    def gaps(dt, v, j, _):
        rv, rj, _ = ref[dt]
        return {"mesh_rel_rms": _rms(v - rv) / spread_v,
                "mesh_row_rel_rms_max": float(
                    (v - rv).double().pow(2).mean((1, 2)).sqrt().max())
                / spread_v,
                "joints_rel_rms": _rms(j - rj) / spread_j}

    for dt in (f32, bf16):
        good = gaps(dt, *got[dt])
        record_property(str(dt)[6:], good)
        assert all(good[m] <= CROP_BARS[dt][m] for m in good), (dt, good)

    def shifted(q, k, v, scale, out=None, use_kernel=True):
        res = fused_attention_into(q, k, v, scale, out, use_kernel)
        if q.shape[1] > 1:                    # the backbone's launches
            res.copy_(res.roll(1, dims=0))
        return res

    monkeypatch.setattr(hmr2, "fused_attention_into", shifted)
    bad = gaps(bf16, *make_serving_fn(model, bf16)(x))
    record_property("planted_fault_bfloat16", bad)
    assert all(bad[m] > CROP_BARS[bf16][m] for m in bad), bad
