"""The plain reference against the port's plain path on the CPU, at a
tiny batch and the published widths: in float32 the two agree to
rounding, so the reference computes what the port computes."""
import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.tests import cells
from benchmark.reference import graph
from benchmark.reference import model as ref

SERVE = "serve-b2048.gator-h36m17"
TRAIN = ["train2-flagship-b512.gator-coco19",
         "train2-gtinput-b512.gator-h36m17"]


@pytest.mark.parametrize("joint_set", ["human36", "coco"])
def test_reference_tables_match_port(joint_set):
    """The tables the reference works out again from the raw files equal
    the program's own (its graph precompute, coarse template and joint
    assignment), so that a fault in either shows here."""
    from gator_tpu_torch.assets import build_assets
    assets = build_assets(joint_set, data_dirs=[])
    got = ref.arrays_of(assets, joint_set)
    port = {"adjacency": assets.graph.adjacency,
            "degree": assets.graph.degree,
            "spatial_pos": assets.graph.spatial_pos,
            "edge_input": assets.graph.edge_input,
            "hop_recip": assets.graph.hop_recip,
            "masks_xfeat": assets.graph.masks_xfeat,
            "init_verts_coarse": assets.init_verts_coarse,
            "init_verts_full": assets.mean_vertices,
            "vj_relation": assets.vj_relation}
    assert set(got) == set(ref.TABLE_KEYS) == set(port)
    for k in ref.TABLE_KEYS:
        a, b = np.asarray(got[k]), np.asarray(port[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "iu" or k in ("adjacency", "masks_xfeat"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert got["edge_input"].any() and got["masks_xfeat"][1].any()
    assert len(np.unique(got["vj_relation"])) > 1


def test_reference_tables_follow_the_skeleton():
    """A hand count on H36M: the pelvis (0) reaches the head (10) in four
    hops through the torso, neck and nose; the pruned flip pair (1, 4)
    leaves the two hips two hops apart, through the pelvis."""
    d, p = graph.floyd_warshall(graph.adjacency("human36"))
    assert d[0, 10] == 4 and d[1, 4] == 2 and d[0, 0] == 0
    assert graph._between(p, 0, 10) == [7, 8, 9]
    assert graph._between(p, 1, 4) == [0]
    assert p[0, 7] == graph.SENTINEL


@pytest.mark.parametrize("config", ["gator-h36m17", "gator-coco19"])
def test_serving_reference_matches_port_f32(config):
    from gator_tpu_torch.serving import make_serving_fn
    drv = spec.driver("serve_closed")
    cfg = spec.config(config)
    assets, model, w = drv.build_model(cfg, torch.device("cpu"), 11, None)
    serve = make_serving_fn(model, torch.float32, use_kernels=False)
    x = drv.make_pool(11, 1, 4, cfg["num_joint"], "cpu")[0]
    mesh, pose3d = serve(x)
    with torch.no_grad():
        tables = ref.tables_on(
            ref.arrays_of(assets, cfg["input_joint_set"]), "cpu")
        m_r, p_r, _ = ref.forward(w, tables, cfg, x)
    assert float((mesh - m_r).abs().max()) < 1e-5
    assert float((pose3d - p_r).abs().max()) < 1e-5 * float(
        p_r.abs().max())


@pytest.mark.parametrize("cell", TRAIN)
def test_training_reference_matches_port_f32(cell, monkeypatch):
    """One run of the train driver in f32 (the port's plain K4/K5 on the
    CPU): the reference's assembly and steps agree to rounding."""
    parts = cells.parts(cell)
    cells.small_recipe(monkeypatch, parts["driver"], "float32")
    cfg = dict(parts["config"], precision="float32")
    res = cells.run(cell, cells.small_mix(cell), cfg)
    v = res.values
    assert v["pose2d_max_abs"] < 1e-5
    assert v["mesh_target_max_abs_m"] < 1e-5
    assert v["lift_target_max_abs_mm"] < 1e-2
    assert v["gates_differ_share"] == 0.0
    assert v["loss_rel_max"] < 1e-5
    assert v["grad1_norm_gap"] < 1e-3
    assert v["delta_norm_gap"] < 1e-3
