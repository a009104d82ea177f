"""The port's asset bundle against the JAX package's, for both joint sets at
the test size (890 vertices) and the full 6890: integer tables exact, float
tables within 1e-6 (the JAX side may take its graph tables from the native
library, the port always from numpy)."""
import dataclasses
import os

import numpy as np
import pytest

from gator_tpu.assets import build_assets as jax_build_assets
from gator_tpu_torch.assets import build_assets


def _leaves(obj, prefix=""):
    """(name, array) for every array field, walking nested dataclasses."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}{f.name}.")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], f"{prefix}{k}.")
    elif isinstance(obj, (np.ndarray, tuple, int, str, float)):
        yield prefix.rstrip("."), obj


@pytest.mark.parametrize("vertices", [890, 6890])
@pytest.mark.parametrize("joint_set", ["human36", "coco"])
def test_build_assets_matches_jax(joint_set, vertices):
    ours = dict(_leaves(build_assets(joint_set, data_dirs=[],
                                     synthetic_vertex_num=vertices, seed=0)))
    ref = dict(_leaves(jax_build_assets(joint_set, data_dirs=[],
                                        synthetic_vertex_num=vertices,
                                        seed=0)))
    assert ours.keys() == ref.keys()
    assert ours["init_verts_coarse"].shape[0] == {890: 56, 6890: 431}[
        vertices]
    for name, want in ref.items():
        got = ours[name]
        if isinstance(want, np.ndarray) and want.dtype.kind == "f":
            assert got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)


def test_hop_path_tables_match_goldens():
    """The human36 graph tables against tests/golden (test_golden.py:59)."""
    golden = os.path.join(os.path.dirname(__file__), "golden")
    g = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                     seed=0).graph
    for name, table in (("h36m_spatial_pos", g.spatial_pos),
                        ("h36m_edge_input", g.edge_input),
                        ("h36m_hop_recip", g.hop_recip)):
        np.testing.assert_allclose(
            table.astype(np.float32),
            np.load(os.path.join(golden, name + ".npy")), atol=1e-5,
            err_msg=name)
