"""MotionBERT's mesh model in the port (`models/motionbert.py`, served by
`serving.make_serving_fn`) against the benchmark's plain reference
(`benchmark/reference/motionbert.py`), on the CPU at a small size:
dim_feat 32, depth 2, 4 heads, T = 4, B = 3 clips, the 890-vertex seeded
SMPL stand-in; weights from the benchmark's rules (core/mb_weights.py).
Also the SPIN 6D layout, the rotation-matrix SMPL entry, world-1 sharded
serving, the two-batch-dimension attention's plain path, a MotionBERT
checkpoint's layout and the serve CLI's clip mode."""
import numpy as np
import pytest
import torch

from benchmark.core import check, mb_weights
from benchmark.reference import motionbert as ref
from gator_tpu_torch import make_serving_fn, make_sharded_serving_fn
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.bodymodel import (SmplParams, axis_angle_to_rotmat,
                                       rot6d_to_rotmat, rot6d_to_rotmat_spin,
                                       smpl_forward, smpl_forward_rotmat)
from gator_tpu_torch.models import (MeshRegressor, MotionBertSpec,
                                    build_motionbert_mesh)
from gator_tpu_torch.nn import fused_attention_into, fused_attention_ref
from gator_tpu_torch.nn.fused_attention import _check
from gator_tpu_torch.parallel import single

SPEC = MotionBertSpec(dim_feat=32, dim_rep=32, depth=2, num_heads=4,
                      hidden_dim=64)
CFG = {"layer_norm_eps": SPEC.eps, "num_heads": SPEC.num_heads,
       "depth": SPEC.depth}
B, T = 3, 4


@pytest.fixture(scope="module")
def assets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                        seed=0)


def seeded(assets, round_to=None, seed=2**31 + 5):
    """A small model with the benchmark's weight rules -> (model, w)."""
    model = MeshRegressor(SPEC, assets.smpl, assets.j_regressor_h36m).eval()
    w = mb_weights.make(model.state_dict(), seed, "cpu", round_to)
    full = model.state_dict()
    full.update(w)
    model.load_state_dict(full)
    return model, w


def clips(seed=3, b=B, t=T):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(b, t, 17, 3, generator=gen)
    return torch.cat([x[..., :2] * 2 - 1, x[..., 2:]], -1)


def reference(assets, w, x):
    tables = ref.tables_of(assets, "cpu")
    verts, kp3d = ref.forward(w, tables, CFG, x)
    init_v, init_k = ref.init_mesh(w, tables)
    return verts, kp3d, init_v, init_k


def test_published_state_dict_names(assets):
    keys = set(build_motionbert_mesh(assets, SPEC, device="cpu")
               .state_dict())
    for k in ("backbone.joints_embed.weight", "backbone.pos_embed",
              "backbone.temp_embed", "backbone.blocks_st.0.norm1_s.weight",
              "backbone.blocks_ts.1.attn_t.qkv.bias",
              "backbone.blocks_st.1.mlp_t.fc2.weight",
              "backbone.ts_attn.1.bias", "backbone.norm.bias",
              "backbone.pre_logits.fc.weight", "backbone.head.weight",
              "head.fc1.weight", "head.bn2.running_var",
              "head.head_pose.weight", "head.head_shape.bias",
              "head.init_pose", "head.init_shape"):
        assert k in keys, k


def test_serving_matches_reference_f32(assets):
    model, w = seeded(assets)
    x = clips()
    verts, kp3d = make_serving_fn(model, torch.float32)(x)
    want_v, want_k, init_v, _ = reference(assets, w, x)
    assert verts.shape == (B, T, 890, 3) and kp3d.shape == (B, T, 17, 3)
    assert verts.dtype == torch.float32
    # the input decides the answer: the meshes move well off the init mesh
    assert check.rms(want_v - init_v) > 0.01
    torch.testing.assert_close(verts, want_v, rtol=0, atol=1e-5)
    torch.testing.assert_close(kp3d, want_k, rtol=0, atol=1e-5)
    again, _ = model(x)                       # the module form, f32
    torch.testing.assert_close(again, want_v, rtol=0, atol=1e-5)


def test_serving_matches_reference_bf16(assets):
    """bf16 backbone and head against the f32 reference on the same
    (bf16-rounded) weights: within the bf16 budget, and a planted fault
    (one clip's frames swapped) is seen by the same number."""
    model, w = seeded(assets, round_to=torch.bfloat16)
    x = clips(seed=4)
    verts, kp3d = make_serving_fn(model, torch.bfloat16)(x)
    want_v, want_k, init_v, init_k = reference(assets, w, x)
    scale = check.rms(want_v - init_v)
    err = check.rel_rms(verts, want_v, scale)
    assert err < 0.03, err
    assert check.rel_rms(kp3d, want_k, check.rms(want_k - init_k)) < 0.03
    swapped = verts.clone()
    swapped[0] = verts[0].flip(0)
    assert check.row_rel_rms_max(swapped, want_v, scale) > 10 * err


def test_spin_6d_layout_against_a_hand_built_rotation():
    rot = axis_angle_to_rotmat(torch.tensor([[0.3, -1.1, 0.7]]))[0]
    spin = rot[:, :2].reshape(6)              # [[a1_0, a2_0], [a1_1, ...]
    torch.testing.assert_close(rot6d_to_rotmat_spin(spin), rot, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(ref.rot6d_to_rotmat(spin)[0], rot, rtol=0,
                               atol=1e-6)
    # manopth's layout reads the same six numbers as [a1 | a2]
    assert (rot6d_to_rotmat(spin) - rot).abs().max() > 0.1
    torch.testing.assert_close(
        rot6d_to_rotmat(torch.cat([rot[:, 0], rot[:, 1]])), rot, rtol=0,
        atol=1e-6)


def test_rotmat_smpl_entry_matches_axis_angle(assets):
    params = SmplParams.from_model(assets.smpl, "cpu")
    gen = torch.Generator().manual_seed(7)
    pose = torch.randn(5, 72, generator=gen) * 0.4
    betas = torch.randn(5, 10, generator=gen)
    verts, joints = smpl_forward(params, pose, betas)
    rot = axis_angle_to_rotmat(pose.reshape(5, 24, 3))
    got_v, got_j = smpl_forward_rotmat(params, rot, betas)
    torch.testing.assert_close(got_v, verts, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_j, joints, rtol=0, atol=1e-6)
    # and smplx's 4x4 chain, the reference's order
    torch.testing.assert_close(
        ref.smpl_rotmat(ref.tables_of(assets, "cpu")["smpl"], rot, betas),
        verts, rtol=0, atol=1e-5)


def test_sharded_serving_at_world_one(assets):
    model, _ = seeded(assets)
    x = clips(seed=5)
    got = make_sharded_serving_fn(model, single("cpu"), torch.float32)(x)
    want = make_serving_fn(model, torch.float32)(x)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_two_batch_dim_attention_plain_path():
    """The temporal attention's layout: q, k, v [clips, joints, T, H, D]
    views of a [clips, T, joints, 3, H, D] product, written into a
    [clips, T, joints, H, D] buffer through its permuted view."""
    gen = torch.Generator().manual_seed(9)
    qkv = torch.randn(2, 5, 3, 3, 2, 8, generator=gen)
    q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3, 4) for i in range(3))
    _check(q, k, v, None)
    out = torch.empty(2, 5, 3, 2, 8)
    got = fused_attention_into(q, k, v, 0.3, out.permute(0, 2, 1, 3, 4))
    assert got.data_ptr() == out.data_ptr()
    for c in range(2):
        for j in range(3):
            want = fused_attention_ref(q[c, j][None], k[c, j][None],
                                       v[c, j][None], None, 0.3)[0]
            torch.testing.assert_close(out[c, :, j], want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        _check(q, k[:, :2], v, None)


def test_motionbert_checkpoint_layout_loads(assets, tmp_path):
    """MotionBERT saves {"model": state dict} with DataParallel's
    "module." prefix and its SMPL layer's tables under head.smpl."""
    from gator_tpu_torch.train.checkpoint import load_weights
    src, w = seeded(assets)
    state = {"module." + k: v for k, v in src.state_dict().items()}
    state["module.head.smpl.v_template"] = torch.zeros(890, 3)
    path = tmp_path / "best_epoch.bin"
    torch.save({"epoch": 3, "model": state}, path)
    dst = build_motionbert_mesh(assets, SPEC, device="cpu")
    load_weights(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    state["module.head.extra"] = torch.zeros(1)
    torch.save({"model": state}, path)
    with pytest.raises(RuntimeError):
        load_weights(dst, str(path))


def test_serve_cli_clip_mode(assets, tmp_path, monkeypatch):
    from gator_tpu_torch.cli import serve as cli
    model, _ = seeded(assets)
    monkeypatch.setattr(cli, "build_motionbert_mesh",
                        lambda a, seed, device: model)
    x = clips(seed=6, b=5)[..., :2].numpy()
    np.save(tmp_path / "clips.npy", x)
    out = cli.run_serve_clips(
        str(tmp_path / "clips.npy"), output=str(tmp_path / "m.npy"),
        joints_output=str(tmp_path / "j.npy"), batch_size=2,
        dtype="float32", device="cpu", assets=assets,
        obj_dir=str(tmp_path / "objs"), obj_every=2)
    want, want_k = make_serving_fn(model, torch.float32)(
        torch.cat([torch.from_numpy(x), torch.ones(5, T, 17, 1)], -1))
    # served in chunks of 2 clips: f32 sums in another order
    np.testing.assert_allclose(out["meshes"], want.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.load(tmp_path / "j.npy"), want_k.numpy(),
                               rtol=0, atol=1e-6)
    assert len(list((tmp_path / "objs").iterdir())) == 3
