"""MotionBERT's serving path on a card: K3 at the clip shapes against its
plain version, K3's second batch dimension against the one-dimension
launch, K3's short-row kernel (Nq, Nk <= 32) against its plain version and
bit for bit against the tiled kernel's C entry on the same inputs, and the
served clips against the plain float32 reference at the published widths.
Skips without a card.

This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_motionbert_cuda.py
Bars: K3 as tests/test_torch_eval_kernels_cuda.py (f32 atol 1e-4, bf16
5e-2: sums in another order can flip a bf16 rounding of a probability);
the second batch dimension and the output strides move no arithmetic, so
bit-equal; the short-row kernel runs the tiled kernel's arithmetic, so
bit-equal to it; the served clips held to the cell's own limits
(benchmark/traffic/serve-clip16-b128.json), and on K3 against the same call
on plain attention at the cell's 128 clips (gaps as shares of the clips'
RMS spread: f32 1e-3 / 2e-3 / 1e-3, bf16 0.2 / 0.3 / 0.2), with a planted
fault in the temporal launches' addressing that the bf16 bars see.
"""
import pytest
import torch

from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.models import build_motionbert_mesh, motionbert
from gator_tpu_torch.nn import cuda_lib
from gator_tpu_torch.nn.fused_attention import (_SIGNATURE, HEAD_DIMS,
                                                _launch, fused_attention,
                                                fused_attention_into,
                                                fused_attention_ref,
                                                short_plan)
from gator_tpu_torch.serving import make_serving_fn
from torch_fixtures import launched, only

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(card, n, t, j, dtype, seed=0):
    """A [clips, T, J, 3, 8, 64] qkv product, as the model's."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(n, t, j, 3, 8, 64, generator=gen,
                       device=card).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_spatial_17_tokens(card, dtype):
    """The spatial attention: [clips*T, 17, 8, 64] views of qkv, at the
    cell's 128 clips (2048 frames: several samples a persistent CTA, so
    the cp.async ring's second stage fills)."""
    qkv = _qkv(card, 128, 16, 17, dtype)
    q, k, v = (qkv[:, :, :, i].reshape(2048, 17, 8, 64) for i in range(3))
    before = fused_attention.launches
    with torch.no_grad():
        got = fused_attention_into(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert short_plan(2048, 17, 17, 8, 64, dtype)["heads_per_unit"] == 8
    want = fused_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_temporal_16_tokens(card, dtype):
    """The temporal attention: [clips, 17, T=16, 8, 64] views of qkv (two
    batch dimensions), written through a permuted view into [clips, T,
    17, 8, 64], at the cell's 128 clips (2176 samples)."""
    qkv = _qkv(card, 128, 16, 17, dtype, seed=1)
    q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3, 4) for i in range(3))
    out = torch.empty(128, 16, 17, 8, 64, dtype=dtype, device=card)
    with torch.no_grad():
        fused_attention_into(q, k, v, 0.125, out.permute(0, 2, 1, 3, 4))
    torch.cuda.synchronize()
    flat = [z.reshape(128 * 17, 16, 8, 64) for z in (q, k, v)]
    want = fused_attention_ref(*flat, None, 0.125).reshape(128, 17, 16, 8,
                                                           64)
    got = out.permute(0, 2, 1, 3, 4)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    # the same bits as the one-dimension launch into a contiguous tensor
    with torch.no_grad():
        one = fused_attention_into(*flat, 0.125).view(128, 17, 16, 8, 64)
    assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_second_batch_dim_is_bit_equal(card, dtype):
    """The eval path's shape (B = 512, 431 x 431, 2 heads of 32, with and
    without the bias) through the one-dimension launch and as [128, 4]
    samples written into a permuted buffer: the same bits."""
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(512, 431, 2, 32, generator=gen, device=card)
               .to(dtype) for _ in range(3))
    bias = torch.randn(2, 431, 431, generator=gen, device=card)
    for b in (None, bias):
        with torch.no_grad():
            one = fused_attention(q, k, v, b, 0.17)
            out = torch.empty(431, 128, 4, 2, 32, dtype=dtype, device=card)
            _launch(*(z.view(128, 4, 431, 2, 32) for z in (q, k, v)), b,
                    0.17, out.permute(1, 2, 0, 3, 4))
        torch.cuda.synchronize()
        assert torch.equal(out.permute(1, 2, 0, 3, 4).reshape(one.shape),
                           one)


def _tiled(q, k, v, bias, scale):
    """The tiled kernel's C entry on contiguous [B, N, H, D] tensors,
    whatever the route would take."""
    lib = cuda_lib.load("fused_attention", _SIGNATURE)
    out = torch.empty_like(q)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    bias = None if bias is None else bias.contiguous()
    strides = [(t.stride(0), 0, t.stride(1), t.stride(2))
               for t in (q, k, v, out)]
    cuda_lib.check(lib.fused_attention_launch(
        cuda_lib.kernel_dtype(q.dtype), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, 1, nq, nk, h, *strides[0], *strides[1],
        *strides[2], *strides[3], float(scale),
        cuda_lib.stream_ptr(q)), "fused_attention_launch")
    return out


SHORT = [(n, n) for n in (1, 2, 15, 16, 17, 31, 32)] + [
    (1, 32), (32, 1), (17, 16), (16, 17), (5, 29), (29, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_short_kernel_matches_ref_and_tiled_bits(card, d, dtype):
    """Nq = Nk in {1, 2, 15, 16, 17, 31, 32} and Nq != Nk, with and without
    the bias, at 3 heads (a unit of 3 heads, two samples a ring stage) and
    8 (MotionBERT's): within the bar of the plain version, and the tiled
    kernel's bits; each launch counted as a short one."""
    gen = torch.Generator(device=card).manual_seed(d)
    for nq, nk in SHORT:
        for h in (3, 8):
            q = torch.randn(37, nq, h, d, generator=gen, device=card)
            k, v = (torch.randn(37, nk, h, d, generator=gen, device=card)
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            bias = torch.randn(h, nq, nk, generator=gen, device=card)
            for b in (None, bias):
                before = (fused_attention.launches,
                          fused_attention.short_launches)
                with torch.no_grad():
                    got = fused_attention(q, k, v, b, d ** -0.5)
                    tiled = _tiled(q, k, v, b, d ** -0.5)
                torch.cuda.synchronize()
                assert (fused_attention.launches,
                        fused_attention.short_launches) == (
                            before[0] + 1, before[1] + 1)
                want = fused_attention_ref(q, k, v, b, d ** -0.5)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= TOL[dtype], (nq, nk, h, b is None, err)
                assert torch.equal(got, tiled), (nq, nk, h, b is None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_kernel_head_groups_and_odd_strides(card, dtype):
    """64 heads of 64 outgrow the ring: the kernel takes groups of heads.
    Views whose rows are not 16-byte aligned: q, k and v go to copies, out
    to a fresh tensor copied back; the aligned launch's bits, and the tiled
    kernel's."""
    gen = torch.Generator(device=card).manual_seed(5)
    hg = short_plan(9, 32, 32, 64, 64, dtype)["heads_per_unit"]
    assert hg < 64 and 64 % hg == 0
    q, k, v = (torch.randn(9, 32, 64, 64, generator=gen, device=card)
               .to(dtype) for _ in range(3))
    n = q.numel()
    flat = torch.empty(4 * n + 1, dtype=dtype, device=card)
    qo, ko, vo, oo = (flat[1 + i * n:1 + (i + 1) * n].view(q.shape)
                      for i in range(4))
    for src, dst in ((q, qo), (k, ko), (v, vo)):
        dst.copy_(src)
    with torch.no_grad():
        got = fused_attention(q, k, v, None, 0.125)
        fused_attention_into(qo, ko, vo, 0.125, oo)
        tiled = _tiled(q, k, v, None, 0.125)
    torch.cuda.synchronize()
    want = fused_attention_ref(q, k, v, None, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(oo, got)
    assert torch.equal(tiled, got)


@pytest.mark.cuda
def test_short_launches_count_only_short_rows(card):
    """fused_attention.short_launches counts the short route's launches:
    the spatial and temporal shapes, not the 431-key eval shape."""
    qkv = _qkv(card, 2, 16, 17, torch.bfloat16)
    q, k, v = qkv.unbind(3)
    before = (fused_attention.launches, fused_attention.short_launches)
    with torch.no_grad():
        fused_attention_into(*(z.reshape(32, 17, 8, 64) for z in (q, k, v)),
                             0.125)
        fused_attention_into(*(z.permute(0, 2, 1, 3, 4) for z in (q, k, v)),
                             0.125)
        e = torch.randn(2, 431, 2, 32, device=card).to(torch.bfloat16)
        fused_attention(e, e, e, None, 0.17)
    assert (fused_attention.launches - before[0],
            fused_attention.short_launches - before[1]) == (3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_kernel_bar_sees_one_wrong_key(card, dtype):
    """A planted fault: one key of one (sample, head) replaced before the
    launch; the bar against the plain version on the true keys sees it."""
    qkv = _qkv(card, 4, 16, 17, dtype, seed=3)
    q, k, v = (z.reshape(64, 17, 8, 64) for z in qkv.unbind(3))
    bad = k.clone()
    bad[40, 11, 5] = -3 * bad[40, 11, 5]
    with torch.no_grad():
        got = fused_attention(q, bad, v, None, 0.125)
    want = fused_attention_ref(q, k, v, None, 0.125)
    assert (got.float() - want.float()).abs().max().item() > TOL[dtype]


@pytest.mark.cuda
def test_served_clips_match_the_reference(card):
    """The cell's own driver parts at B = 8 clips: the port's serving call
    against the plain float32 reference, within the cell's limits, with
    20 K3 launches a call."""
    from benchmark.core import check, spec
    drv = spec.driver("serve_clips")
    cfg, mix = spec.config("motionbert-mesh-h36m17"), \
        spec.traffic("serve-clip16-b128")
    seed = 2**31 + 11
    assets, model, w = drv.build_model(cfg, card, seed, torch.bfloat16)
    serve = drv.make_program(model, torch.bfloat16)
    x = drv.make_pool(seed, 1, 8, cfg["clip_len"], 17, card)[0]
    before = (fused_attention.launches, fused_attention.short_launches)
    out = serve(x)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention.short_launches) == (
        before[0] + 20, before[1] + 20)
    assert out[0].shape == (8, 16, 6890, 3) and out[0].dtype == torch.float32
    from benchmark.reference import motionbert as ref
    values = drv.compare([out], [x], w, ref.tables_of(assets, card), cfg, 8)
    ok, checks = check.judge(values, mix["limits"])
    assert ok, checks


def _rms(z):
    return float(z.double().pow(2).mean().sqrt())


CLIP_BARS = {torch.float32: {"mesh_rel_rms": 1e-3,
                             "mesh_clip_rel_rms_max": 2e-3,
                             "kp3d_rel_rms": 1e-3},
             torch.bfloat16: {"mesh_rel_rms": 0.2,
                              "mesh_clip_rel_rms_max": 0.3,
                              "kp3d_rel_rms": 0.2}}


@pytest.mark.cuda
def test_served_clips_on_k3_match_the_plain_path(card, monkeypatch,
                                                 record_property):
    """128 clips of 16 frames served through `make_serving_fn` in f32 and
    bf16, on K3 against the same call with use_kernels=False. The gaps are
    shares of what the clips decide: the plain f32 call's RMS distance
    from its mean over the clips. In bf16 a probability that rounds the
    other way moves the tokens by bf16 roundings, several % of that part;
    f32 holds the call to K3's own error. MotionBERT's head starts at
    xavier gain 0.01, where the mesh hardly depends on the input: gain 1
    and a drawn stream gate make a fault in an attention move the mesh.
    The planted fault, each clip's temporal output written into the next
    clip's, must read outside every bf16 bar. The bf16 call launches K3
    20 times, all on the short-row kernel, and no other kernel. The gaps
    go to the JUnit report (`--junitxml`) as properties."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, t, j = 128, 16, 17
    gen = torch.Generator().manual_seed(32)
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=6890, seed=0)
    model = build_motionbert_mesh(assets, seed=1, device=card)
    with torch.no_grad():
        model.head.head_pose.weight.mul_(100.0)
        model.head.head_shape.weight.mul_(100.0)
        for lin in model.backbone.ts_attn:
            lin.weight.copy_(torch.randn(*lin.weight.shape, generator=gen)
                             * 0.02)
    u = torch.rand(n, t, j, 3, generator=gen)
    clips = torch.cat([u[..., :2] * 2 - 1, u[..., 2:]], -1).to(card)

    short = fused_attention.short_launches
    with launched() as counts:
        got = {bf16: make_serving_fn(model, bf16)(clips)}
    only(counts, fused_attention=20)
    assert fused_attention.short_launches - short == 20
    verts, kp3d = got[bf16]
    assert verts.shape == (n, t, 6890, 3) and verts.dtype == f32
    assert kp3d.shape == (n, t, j, 3)
    got[f32] = make_serving_fn(model, f32)(clips)
    ref = {dt: make_serving_fn(model, dt, use_kernels=False)(clips)
           for dt in (f32, bf16)}
    ref_v, ref_k = ref[f32]
    spread_v = _rms(ref_v - ref_v.mean(0, keepdim=True))
    spread_k = _rms(ref_k - ref_k.mean(0, keepdim=True))
    assert spread_v > 1e-3, spread_v

    def gaps(dt, v, k):
        rv, rk = ref[dt]
        return {"mesh_rel_rms": _rms(v - rv) / spread_v,
                "mesh_clip_rel_rms_max": float(
                    (v - rv).double().pow(2).mean((1, 2, 3)).sqrt().max())
                / spread_v,
                "kp3d_rel_rms": _rms(k - rk) / spread_k}

    for dt in (f32, bf16):
        good = gaps(dt, *got[dt])
        record_property(str(dt)[6:], good)
        assert all(good[m] <= CLIP_BARS[dt][m] for m in good), (dt, good)

    def shifted(q, k, v, scale, out=None, use_kernel=True):
        res = fused_attention_into(q, k, v, scale, out, use_kernel)
        if q.dim() == 5:
            res.copy_(res.roll(1, dims=0))
        return res

    monkeypatch.setattr(motionbert, "fused_attention_into", shifted)
    bad = gaps(bf16, *make_serving_fn(model, bf16)(clips))
    record_property("planted_fault_bfloat16", bad)
    assert all(bad[m] > CLIP_BARS[bf16][m] for m in bad), bad
