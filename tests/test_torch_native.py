"""The port's binding of the native graph-precompute library
(`gator_tpu_torch.assets.native`): it builds `native/graph_precompute.cc`
with the host's C++ compiler into a build directory of its own (a temp
directory here), and its Floyd-Warshall, edge-input expansion and HEM
matching equal the numpy forms exactly, as tests/test_native.py holds the
JAX package's binding; so do the graph tables and the coarsening built
either way."""
import os

import numpy as np
import pytest
import scipy.sparse as sp

from gator_tpu_torch.assets import (build_assets, coarsening, graphs, native,
                                    skeletons)

JOINT_SETS = {"human36": skeletons.H36M, "coco": skeletons.COCO}


@pytest.fixture(scope="module")
def lib_dir(tmp_path_factory):
    """Builds the library into a temp directory for this module's tests."""
    build_dir = str(tmp_path_factory.mktemp("native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", build_dir)
        yield build_dir


def test_builds_from_the_repo_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    assert not native.available()
    path = native.build()
    assert path == str(tmp_path / "libgator_precompute.so")
    assert native.available() and native.load_library() is not None
    mtime = os.path.getmtime(path)
    assert native.build() == path and os.path.getmtime(path) == mtime
    assert os.listdir(tmp_path) == ["libgator_precompute.so"]


def test_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "g++ -DGATOR_BROKEN -include /nonexistent.h")
    with pytest.raises(RuntimeError, match="nonexistent.h"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    assert not native.available()


@pytest.mark.parametrize("joint_set", sorted(JOINT_SETS))
def test_floyd_warshall_and_edge_input_equal_numpy(lib_dir, joint_set):
    adj = skeletons.gat_adjacency(JOINT_SETS[joint_set])
    dist, path = native.floyd_warshall(adj)
    want_d, want_p = graphs.floyd_warshall(adj)
    np.testing.assert_array_equal(dist, want_d)
    np.testing.assert_array_equal(path, want_p)
    joints = np.random.default_rng(0).normal(
        size=(len(adj), 3)).astype(np.float32)
    feat = graphs.bone_length_matrix(adj, joints)
    md = int(dist.max())
    np.testing.assert_array_equal(native.gen_edge_input(md, path, feat),
                                  graphs.gen_edge_input(md, path, feat))


def test_floyd_warshall_raises_on_a_disconnected_graph(lib_dir):
    adj = np.zeros((4, 4), np.float32)
    adj[0, 1] = adj[1, 0] = 1
    with pytest.raises(ValueError, match="disconnected"):
        native.floyd_warshall(adj)


@pytest.mark.parametrize("joint_set", sorted(JOINT_SETS))
def test_build_graph_tables_native_equals_numpy(lib_dir, joint_set):
    adj = skeletons.gat_adjacency(JOINT_SETS[joint_set])
    joints = np.random.default_rng(1).normal(
        size=(len(adj), 3)).astype(np.float32)
    got = graphs.build_graph_tables(adj, joints, use_native=True)
    want = graphs.build_graph_tables(adj, joints, use_native=False)
    for field in want.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, field)
    # None takes the built library
    again = graphs.build_graph_tables(adj, joints)
    np.testing.assert_array_equal(again.edge_input, want.edge_input)


def test_hem_match_equals_numpy(lib_dir):
    w = sp.random(60, 60, density=0.15, random_state=0)
    w = ((w + w.T) > 0).astype(np.float32).tocsr()
    w.setdiag(0)
    w.eliminate_zeros()
    np.testing.assert_array_equal(native.hem_match(w),
                                  coarsening.heavy_edge_matching(w))


def test_coarse_graphs_native_equal_numpy(lib_dir):
    faces = build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                         seed=0).faces
    adj = skeletons.gat_adjacency(skeletons.H36M)
    got = coarsening.build_coarse_graphs(faces, adj, use_native=True)
    want = coarsening.build_coarse_graphs(faces, adj, use_native=False)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
