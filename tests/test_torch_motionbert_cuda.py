"""MotionBERT's serving path on a card: K3 at the clip shapes against its
plain version, K3's second batch dimension against the one-dimension
launch, and the served clips against the plain float32 reference at the
published widths. Skips without a card.

This file imports no JAX:
    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_motionbert_cuda.py
Bars: K3 as tests/test_torch_eval_kernels_cuda.py (f32 atol 1e-4, bf16
5e-2: sums in another order can flip a bf16 rounding of a probability);
the second batch dimension and the output strides move no arithmetic, so
bit-equal; the served clips held to the cell's own limits
(benchmark/traffic/serve-clip16-b128.json).
"""
import pytest
import torch

from gator_tpu_torch.nn.fused_attention import (_launch, fused_attention,
                                                fused_attention_into,
                                                fused_attention_ref)

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
    """The spatial attention: [clips*T, 17, 8, 64] views of qkv."""
    qkv = _qkv(card, 16, 16, 17, dtype)
    q, k, v = (qkv[:, :, :, i].reshape(256, 17, 8, 64) for i in range(3))
    before = fused_attention.launches
    with torch.no_grad():
        got = fused_attention_into(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    want = fused_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_temporal_16_tokens(card, dtype):
    """The temporal attention: [clips, 17, T=16, 8, 64] views of qkv (two
    batch dimensions), written through a permuted view into [clips, T,
    17, 8, 64]."""
    qkv = _qkv(card, 16, 16, 17, dtype, seed=1)
    q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3, 4) for i in range(3))
    out = torch.empty(16, 16, 17, 8, 64, dtype=dtype, device=card)
    with torch.no_grad():
        fused_attention_into(q, k, v, 0.125, out.permute(0, 2, 1, 3, 4))
    torch.cuda.synchronize()
    flat = [z.reshape(16 * 17, 16, 8, 64) for z in (q, k, v)]
    want = fused_attention_ref(*flat, None, 0.125).reshape(16, 17, 16, 8, 64)
    got = out.permute(0, 2, 1, 3, 4)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


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
    before = fused_attention.launches
    out = serve(x)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 20
    assert out[0].shape == (8, 16, 6890, 3) and out[0].dtype == torch.float32
    from benchmark.reference import motionbert as ref
    values = drv.compare([out], [x], w, ref.tables_of(assets, card), cfg, 8)
    ok, checks = check.judge(values, mix["limits"])
    assert ok, checks
