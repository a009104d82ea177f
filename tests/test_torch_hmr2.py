"""HMR 2.0 in the port (`models/hmr2.py`, served by
`serving.make_serving_fn`) against the benchmark's plain reference
(`benchmark/reference/hmr2.py`), on the CPU at a small size: embed 160,
2 heads of 80, depth 2, 64 x 64 crops (64 x 48 after the slice, 12
patches), decoder width 64, depth 2, B = 3, the 890-vertex seeded SMPL
stand-in; weights from the benchmark's rules (core/hmr2_weights.py).
Also the places the fp8 control rounds (`ref.FP8Held`), HMR 2.0's 6D
layout, planted faults the bars must see (the patch embed without its
2-pixel pad, the SPIN 6D layout in HMR 2.0's place), the published
state-dict names, a released checkpoint's layout, world-1 sharded serving
and the serve CLI's crop mode."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.core import check, hmr2_weights
from benchmark.reference import hmr2 as ref
from gator_tpu_torch import make_serving_fn, make_sharded_serving_fn
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.bodymodel import (axis_angle_to_rotmat, rot6d_to_rotmat,
                                       rot6d_to_rotmat_spin)
from gator_tpu_torch.models import HMR2, Hmr2Spec, build_hmr2, hmr2
from gator_tpu_torch.parallel import single

SPEC = Hmr2Spec(image_size=64, img_h=64, img_w=48, embed_dim=160, depth=2,
                num_heads=2, dec_dim=64, dec_depth=2, dec_heads=2,
                dec_dim_head=32, dec_mlp_dim=64)
CFG = {"image_size": 64, "img_w": 48, "patch_size": 16, "patch_padding": 2,
       "num_heads": 2, "depth": 2, "layer_norm_eps": 1e-6, "dec_heads": 2,
       "dec_dim_head": 32, "dec_depth": 2, "dec_layer_norm_eps": 1e-5,
       "ief_iters": 1, "focal_length": 5000.0}
B = 3


@pytest.fixture(scope="module")
def assets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                        seed=0)


def seeded(assets, spec=SPEC, round_to=None, seed=2**31 + 25):
    """A small model with the benchmark's weight rules -> (model, w)."""
    model = HMR2(spec, assets.smpl).eval()
    w = hmr2_weights.make(model.state_dict(), seed, "cpu", round_to)
    full = model.state_dict()
    full.update(w)
    model.load_state_dict(full)
    return model, w


def crops(seed=3, b=B):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(b, 3, 64, 64, generator=gen)
    mean = torch.tensor([0.485, 0.456, 0.406])[:, None, None]
    std = torch.tensor([0.229, 0.224, 0.225])[:, None, None]
    return (x - mean) / std


def reference(assets, w, x):
    tables = ref.tables_of(assets, "cpu")
    return ref.forward(w, tables, CFG, x), ref.init_output(w, tables, CFG)


def gaps(got, want, init):
    """Each output's RMS gap over the reference's RMS distance from the
    mean-parameter output (the benchmark's scaling), and the worst crop's
    mesh gap."""
    out = {name: check.rel_rms(g, r, check.rms(r - i))
           for name, g, r, i in zip(("mesh", "joints", "cam_t"), got, want,
                                    init)}
    out["mesh_row"] = check.row_rel_rms_max(got[0], want[0],
                                            check.rms(want[0] - init[0]))
    return out


def test_published_state_dict_names(assets):
    keys = set(build_hmr2(assets, SPEC, device="cpu").state_dict())
    layer = "smpl_head.transformer.transformer.layers.1."
    for k in ("backbone.patch_embed.proj.weight", "backbone.pos_embed",
              "backbone.blocks.1.norm1.weight", "backbone.blocks.0.attn.qkv."
              "bias", "backbone.blocks.1.attn.proj.weight",
              "backbone.blocks.0.norm2.bias", "backbone.blocks.1.mlp.fc1."
              "weight", "backbone.blocks.0.mlp.fc2.bias",
              "backbone.last_norm.weight",
              "smpl_head.transformer.to_token_embedding.weight",
              "smpl_head.transformer.pos_embedding",
              layer + "0.norm.weight", layer + "0.fn.to_qkv.weight",
              layer + "0.fn.to_out.0.bias", layer + "1.fn.to_kv.weight",
              layer + "1.fn.to_q.weight", layer + "1.fn.to_out.0.weight",
              layer + "2.fn.net.0.weight", layer + "2.fn.net.3.bias",
              "smpl_head.decpose.weight", "smpl_head.decshape.bias",
              "smpl_head.deccam.weight", "smpl_head.init_body_pose",
              "smpl_head.init_betas", "smpl_head.init_cam"):
        assert k in keys, k
    # no bias where HMR 2.0's decoder has none
    for k in (layer + "0.fn.to_qkv.bias", layer + "1.fn.to_kv.bias",
              layer + "1.fn.to_q.bias"):
        assert k not in keys, k
    sd = build_hmr2(assets, SPEC, device="cpu").state_dict()
    assert sd["backbone.pos_embed"].shape == (1, 13, 160)   # 12 + 1 slot
    assert SPEC.grid == (4, 3) and Hmr2Spec().grid == (16, 12)


def test_serving_matches_reference_f32(assets):
    """The plain f32 path against the f32 reference: the same arithmetic
    up to the fold (the pos_embed sum, the zero token's embedding, the
    six to_kv products stacked into one) and summation order, so within
    f32 rounding (1e-5 m on meshes of ~1 m)."""
    model, w = seeded(assets)
    x = crops()
    verts, joints, cam_t = make_serving_fn(model, torch.float32,
                                           use_kernels=False)(x)
    (want_v, want_j, want_c), init = reference(assets, w, x)
    assert verts.shape == (B, 890, 3) and joints.shape == (B, 24, 3)
    assert cam_t.shape == (B, 3) and verts.dtype == torch.float32
    # the crop decides the answer: the meshes move well off the init mesh
    assert check.rms(want_v - init[0]) > 0.01
    torch.testing.assert_close(verts, want_v, rtol=0, atol=1e-5)
    torch.testing.assert_close(joints, want_j, rtol=0, atol=1e-5)
    torch.testing.assert_close(cam_t, want_c, rtol=1e-4, atol=0)
    again = model(x)                          # the module form, f32
    torch.testing.assert_close(again[0], want_v, rtol=0, atol=1e-5)


def test_serving_matches_reference_bf16(assets):
    """bf16 products against the f32 reference on the same (bf16-rounded)
    weights: each output's gap within 3 % of what the crop decides (bf16
    keeps 8 bits, 0.4 % a rounding, over a few dozen roundings in a row);
    a planted fault (one crop's meshes swapped with another's) is seen by
    the worst crop's number."""
    model, w = seeded(assets, round_to=torch.bfloat16)
    x = crops(seed=4)
    got = make_serving_fn(model, torch.bfloat16)(x)
    want, init = reference(assets, w, x)
    g = gaps(got, want, init)
    assert all(v < 0.03 for v in g.values()), g
    swapped = got[0].clone()
    swapped[[0, 1]] = got[0][[1, 0]]
    assert check.row_rel_rms_max(swapped, want[0], check.rms(
        want[0] - init[0])) > 10 * g["mesh_row"]


class _Bf16Held:
    """bf16 in the places ref.FP8Held puts fp8: the products' operands and
    every tensor the program holds between operations."""
    q = keep = staticmethod(lambda x: x.bfloat16().float())


class _Bf16Operands:
    q = staticmethod(lambda x: x.bfloat16().float())


def test_held_rounding_models_the_served_type(assets):
    """The control rounds where the program holds its served type: with
    bf16 in FP8Held's places the reference lands as far from the f32
    reference as the port's bf16 call does (0.86-1.12x of it over four
    seeds; bar 0.7-1.4x), and with bf16 operands alone at under half of
    it (0.35-0.48x; bar 0.6x), so the held tensors carry most of the
    served type's error and the control has to round them too."""
    model, w = seeded(assets, round_to=torch.bfloat16)
    x = crops()
    want, init = reference(assets, w, x)
    tables = ref.tables_of(assets, "cpu")

    def mesh_gap(out):
        return gaps(out, want, init)["mesh"]

    port = mesh_gap(make_serving_fn(model, torch.bfloat16,
                                    use_kernels=False)(x))
    held = mesh_gap(ref.forward(w, tables, CFG, x, prec=_Bf16Held))
    operands = mesh_gap(ref.forward(w, tables, CFG, x, prec=_Bf16Operands))
    assert 0.7 < held / port < 1.4, (held, port)
    assert operands < 0.6 * port, (operands, port)
    # the f32 reference has no `keep`: held() leaves it as computed
    assert ref.held(ref.F32, x) is x


def test_hmr2_6d_layout_is_the_ports():
    """HMR 2.0 reads the six numbers as [a1 | a2] (reshape(-1, 2, 3).
    permute(0, 2, 1)): the port's `rot6d_to_rotmat`, not SPIN's."""
    rot = axis_angle_to_rotmat(torch.tensor([[0.3, -1.1, 0.7],
                                             [2.0, 0.1, -0.4]]))
    six = torch.cat([rot[..., :, 0], rot[..., :, 1]], -1)
    torch.testing.assert_close(rot6d_to_rotmat(six), rot, rtol=0, atol=1e-6)
    torch.testing.assert_close(ref.rot6d_to_rotmat(six), rot, rtol=0,
                               atol=1e-6)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(50, 6, generator=gen)
    torch.testing.assert_close(rot6d_to_rotmat(x), ref.rot6d_to_rotmat(x),
                               rtol=0, atol=1e-6)
    assert (rot6d_to_rotmat_spin(six) - rot).abs().max() > 0.1


@pytest.mark.parametrize("fault", ["no_patch_pad", "spin_6d"])
def test_planted_fault_fails_the_bars(assets, monkeypatch, fault):
    """A fault planted in the port, held to the f32 test's bars: the patch
    embed without its 2-pixel pad (the same 12 patches, 2 pixels off), or
    the SPIN 6D layout in HMR 2.0's place. Each moves the answer by far
    more than the f32 bar and than the bf16 test's 3 %."""
    model, w = seeded(assets)
    if fault == "no_patch_pad":
        model.spec = dataclasses.replace(SPEC, patch_padding=0)
        assert model.spec.grid == SPEC.grid
    else:
        monkeypatch.setattr(hmr2, "rot6d_to_rotmat", rot6d_to_rotmat_spin)
    x = crops(seed=5)
    got = make_serving_fn(model, torch.float32, use_kernels=False)(x)
    want, init = reference(assets, w, x)
    assert (got[0] - want[0]).abs().max() > 1e-3
    assert max(gaps(got, want, init).values()) > 0.1


def test_released_checkpoint_layout_loads(assets, tmp_path):
    """HMR 2.0 saves a Lightning checkpoint ({"state_dict": ...}) that also
    holds its SMPL layer's buffers (smpl.*) and its discriminator; both
    are left out, any other unknown key raises."""
    from gator_tpu_torch.train.checkpoint import load_weights
    src, _ = seeded(assets)
    state = dict(src.state_dict())
    state["smpl.v_template"] = torch.zeros(890, 3)
    state["discriminator.D_conv1.weight"] = torch.zeros(32, 9, 1, 1)
    path = tmp_path / "epoch=35-step=1000000.ckpt"
    torch.save({"epoch": 35, "state_dict": state}, path)
    dst = build_hmr2(assets, SPEC, device="cpu")
    load_weights(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    state["smpl_head.extra"] = torch.zeros(1)
    torch.save({"state_dict": state}, path)
    with pytest.raises(RuntimeError):
        load_weights(dst, str(path))


def test_sharded_serving_at_world_one(assets):
    model, _ = seeded(assets)
    x = crops(seed=6)
    got = make_sharded_serving_fn(model, single("cpu"), torch.float32)(x)
    want = make_serving_fn(model, torch.float32)(x)
    assert len(got) == 3
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_serving_refuses_other_crop_sizes(assets):
    model, _ = seeded(assets)
    with pytest.raises(ValueError):
        make_serving_fn(model, torch.float32)(torch.zeros(2, 3, 64, 48))


def test_serve_cli_crop_mode(assets, tmp_path, monkeypatch):
    from gator_tpu_torch.cli import serve as cli
    model, _ = seeded(assets)
    monkeypatch.setattr(cli, "build_hmr2", lambda a, seed, device: model)
    x = crops(seed=7, b=5).numpy()
    np.save(tmp_path / "crops.npy", x)
    out = cli.run_serve_crops(
        str(tmp_path / "crops.npy"), output=str(tmp_path / "m.npy"),
        joints_output=str(tmp_path / "j.npy"),
        cam_output=str(tmp_path / "c.npy"), batch_size=2, dtype="float32",
        device="cpu", assets=assets, obj_dir=str(tmp_path / "objs"),
        obj_every=2)
    want = make_serving_fn(model, torch.float32)(torch.from_numpy(x))
    # served in chunks of 2 crops: f32 sums in another order, held to the
    # f32 bars of test_serving_matches_reference_f32
    for got, w_, tol in zip((out["meshes"], np.load(tmp_path / "j.npy"),
                             np.load(tmp_path / "c.npy")), want,
                            ({"atol": 1e-5}, {"atol": 1e-5}, {"rtol": 1e-4})):
        np.testing.assert_allclose(got, w_.numpy(), **{"rtol": 0, "atol": 0,
                                                       **tol})
    assert len(list((tmp_path / "objs").iterdir())) == 3
    with pytest.raises(ValueError):
        np.save(tmp_path / "bad.npy", x[:, :, :, :48])
        cli.run_serve_crops(str(tmp_path / "bad.npy"), device="cpu",
                            assets=assets)
