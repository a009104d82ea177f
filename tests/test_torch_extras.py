"""The port's small surface modules against the JAX package's, on the same
seeded numpy inputs: the 6D rotations and the SVD projection (f32, 1e-5),
the One-Euro filter (numpy bit-equal; the tensor loop against the JAX scan
within 1e-5), `ops` (MeshResampler, GraphConvolution and GraphResBlock with
flax weights converted by `state_dict_from_jax`, within 1e-5;
`row_normalized_adjacency` equal), the Graclus coarsening (bit-equal
adjacencies, clusters and permutations; rescaled Laplacians within 1e-5,
since the JAX package's ARPACK start vector is random), MANO (the same
synthetic model, forward within 1e-5, the pickle loader on a file written
here), `StepTimer` and `profiling.trace`.

The coarsening comparisons give the JAX package's matching its degrees in
float64. Its numpy form adds `d_v + d_u + 1e-9` in the degrees' float32,
which numpy 1 promoted to float64 with the Python float and numpy 2 (NEP
50) keeps in float32: the 1e-9 is lost and ratio ties between candidates
with different degrees break the other way than in the reference, in the
native library of both packages, and in the port
(`test_jax_numpy_matching_rounds_its_denominator`).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gator_tpu import ops as jops
from gator_tpu import smoothing as jsmooth
from gator_tpu.assets import coarsening as jcoarse
from gator_tpu.assets import native as jnative
from gator_tpu.assets import skeletons as jskel
from gator_tpu.bodymodel import mano as jmano
from gator_tpu.bodymodel import rotations6d as jrot6d
from gator_tpu_torch import ops, profiling, smoothing
from gator_tpu_torch.assets import build_assets
from gator_tpu_torch.assets import coarsening, native
from gator_tpu_torch.bodymodel import mano, rotations6d
from gator_tpu_torch.convert import state_dict_from_jax
from test_torch_readers import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def port_assets():
    return build_assets("human36", data_dirs=[], synthetic_vertex_num=890,
                        seed=0)


# 6D rotations and the SVD projection

def test_rot6d_round_trip_matches_jax():
    x6d = np.random.default_rng(0).normal(size=(64, 6)).astype(np.float32)
    got = rotations6d.rot6d_to_rotmat(torch.from_numpy(x6d))
    want = jrot6d.rot6d_to_rotmat(jnp.asarray(x6d))
    _close(got, want, 1e-5, "rot6d_to_rotmat")
    _close(rotations6d.rotmat_to_rot6d(got),
           jrot6d.rotmat_to_rot6d(want), 1e-5, "rotmat_to_rot6d")


def test_project_to_rotation_matches_jax():
    """SVD signs differ between torch and jnp: the projected rotation, which
    is unique for a non-degenerate input, is compared, and it is a proper
    rotation."""
    mats = np.random.default_rng(1).normal(size=(64, 3, 3)).astype(
        np.float32)
    got = rotations6d.project_to_rotation(torch.from_numpy(mats))
    _close(got, jrot6d.project_to_rotation(jnp.asarray(mats)), 1e-5)
    _close(got @ got.transpose(-1, -2), np.broadcast_to(np.eye(3),
                                                        (64, 3, 3)), 1e-5)
    _close(torch.linalg.det(got), np.ones(64), 1e-5)


# One-Euro smoothing

def test_one_euro_numpy_bit_equal():
    seq = np.random.default_rng(2).normal(size=(40, 17, 3)).astype(
        np.float32)
    for fps in (1.0, 30.0):
        np.testing.assert_array_equal(
            smoothing.one_euro_smooth(seq, fps=fps),
            jsmooth.one_euro_smooth(seq, fps=fps))


def test_one_euro_torch_matches_jax_scan():
    seq = np.cumsum(np.random.default_rng(3).normal(
        size=(40, 17, 3)), 0).astype(np.float32)
    _close(smoothing.one_euro_smooth_torch(torch.from_numpy(seq)),
           jsmooth.one_euro_smooth_jax(jnp.asarray(seq)), 1e-5)


# ops

def test_mesh_resampler_matches_jax(small_assets, port_assets):
    x = np.random.default_rng(4).normal(size=(2, 890, 3)).astype(np.float32)
    jres = jops.MeshResampler(small_assets.sampling)
    res = ops.MeshResampler(port_assets.sampling)
    down = res.downsample(torch.from_numpy(x), 0, 2)
    jdown = jres.downsample(jnp.asarray(x), 0, 2)
    _close(down, jdown, 1e-5, "down")
    _close(res.upsample(down, 2, 0), jres.upsample(jdown, 2, 0), 1e-5, "up")


def _flax_to_port(jmod, mod, x):
    """Init `jmod` on x, load its params into `mod` strictly, and -> (flax
    output, port output)."""
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(params))), strict=True)
    return jmod.apply(params, jnp.asarray(x)), mod(torch.from_numpy(x))


def test_graph_convolution_matches_flax():
    adj = ops.row_normalized_adjacency(jskel.gat_adjacency(jskel.H36M))
    x = np.random.default_rng(5).normal(size=(3, 17, 24)).astype(np.float32)
    want, got = _flax_to_port(jops.GraphConvolution(16, adj),
                              ops.GraphConvolution(24, 16, adj), x)
    _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("cin,cout", [(32, 32), (24, 64)])
def test_graph_res_block_matches_flax(cin, cout):
    """GroupNorm on the last axis of [B, V, C] with eps 1e-6 as flax's; the
    `skip` GraphLinear where the widths differ."""
    adj = ops.row_normalized_adjacency(jskel.gat_adjacency(jskel.COCO), 2)
    x = np.random.default_rng(6).normal(size=(3, 19, cin)).astype(
        np.float32)
    want, got = _flax_to_port(jops.GraphResBlock(cin, cout, adj),
                              ops.GraphResBlock(cin, cout, adj), x)
    _close(got.detach(), want, 1e-5)


def test_row_normalized_adjacency_equal():
    adj = jskel.gat_adjacency(jskel.COCO)
    for n in (1, 2, 3):
        np.testing.assert_array_equal(ops.row_normalized_adjacency(adj, n),
                                      jops.row_normalized_adjacency(adj, n))


# coarsening

def _csr_equal(a, b, what):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{what} {f}")


@pytest.fixture
def jax_f64_matching(monkeypatch):
    """The JAX package's coarsening with its matching's degrees in float64,
    as the reference's numpy computed them (module docstring)."""
    hem = jcoarse.heavy_edge_matching
    monkeypatch.setattr(
        jcoarse, "heavy_edge_matching",
        lambda w, degree=None: hem(w, None if degree is None
                                   else np.asarray(degree, np.float64)))


@pytest.fixture(scope="module")
def level1(port_assets):
    """The mesh graph and its first coarse level (weighted, self-loops)."""
    w0 = coarsening.build_mesh_graph(port_assets.faces, 890)
    w1, _ = coarsening._coarsen_one(w0, np.asarray(w0.sum(0)).ravel(),
                                    False)
    return w0, w1


def test_mesh_graph_and_matching_match_jax(small_assets, port_assets,
                                           level1):
    np.testing.assert_array_equal(port_assets.faces, small_assets.faces)
    w0, w1 = level1
    _csr_equal(w0, jcoarse.build_mesh_graph(small_assets.faces, 890),
               "mesh graph")
    for w in (w0, w1):
        deg = np.asarray(w.sum(0), np.float64).ravel()
        np.testing.assert_array_equal(coarsening.heavy_edge_matching(w),
                                      jcoarse.heavy_edge_matching(w, deg))


def test_jax_numpy_matching_rounds_its_denominator(level1):
    """The witness for the float64 seam: on the first coarse level the
    JAX package's numpy matching (float32 denominators) disagrees with its
    own native library, which the port's numpy form and the float64 JAX
    form both equal."""
    _, w1 = level1
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    want = jnative.hem_match(w1.astype(np.float32))
    port = coarsening.heavy_edge_matching(w1)
    np.testing.assert_array_equal(port, want)
    assert (jcoarse.heavy_edge_matching(w1) != want).any()


def test_coarsen_and_perms_match_jax(small_assets, port_assets,
                                     jax_f64_matching):
    adj = coarsening.build_mesh_graph(port_assets.faces, 890)
    graphs, perm = coarsening.coarsen(adj, 4, use_native=False)
    jgraphs, jperm = jcoarse.coarsen(
        jcoarse.build_mesh_graph(small_assets.faces, 890), 4)
    np.testing.assert_array_equal(perm, jperm)
    for i, (g, jg) in enumerate(zip(graphs, jgraphs)):
        _csr_equal(g, jg, f"level {i}")
    # compute_perm and perm_adjacency on the same parents
    parents, w, deg = [], adj, np.asarray(adj.sum(0)).ravel()
    for _ in range(3):
        w, cluster = coarsening._coarsen_one(w, deg, False)
        parents.append(cluster)
        deg = np.asarray(w.sum(0)).ravel()
    perms = coarsening.compute_perm(parents)
    for p, jp in zip(perms, jcoarse.compute_perm(parents)):
        np.testing.assert_array_equal(p, jp)
    _csr_equal(coarsening.perm_adjacency(adj, perms[0]),
               jcoarse.perm_adjacency(adj, perms[0]), "perm_adjacency")
    np.testing.assert_array_equal(coarsening.perm_index_reverse(perms[0]),
                                  jcoarse.perm_index_reverse(perms[0]))


def test_build_coarse_graphs_matches_jax(small_assets, port_assets,
                                         jax_f64_matching):
    joint_adj = jskel.gat_adjacency(jskel.H36M)
    adjs, laps, perm, rev = coarsening.build_coarse_graphs(
        port_assets.faces, joint_adj, use_native=False)
    jadjs, jlaps, jperm, jrev = jcoarse.build_coarse_graphs(
        small_assets.faces, joint_adj)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(rev, jrev)
    assert len(adjs) == len(jadjs) == 10
    for i, (a, ja, lap, jlap) in enumerate(zip(adjs, jadjs, laps, jlaps)):
        _csr_equal(a, ja, f"adjacency {i}")
        _close(lap.toarray(), jlap.toarray(), 1e-5, f"laplacian {i}")
    # the port's Laplacians do not move from run to run (seeded ARPACK)
    again = coarsening.build_coarse_graphs(port_assets.faces, joint_adj,
                                           use_native=False)[1]
    for lap, lap2 in zip(laps, again):
        _csr_equal(lap, lap2, "laplacian again")


def test_coarsening_native_default_off_without_library(tmp_path,
                                                       monkeypatch):
    """`use_native=None` takes the library only where it is built: an empty
    build directory means numpy, and nothing is compiled."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    assert not native.available()
    joint_adj = jskel.gat_adjacency(jskel.H36M)
    coarsening.coarsen(sp.csr_matrix(joint_adj), 2)
    assert list(tmp_path.iterdir()) == []


# MANO

def test_synthetic_mano_is_the_jax_model():
    got, want = mano.synthetic_mano(0), jmano.synthetic_mano(0)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "weights", "faces", "hands_components", "hands_mean"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.parents == want.parents
    np.testing.assert_array_equal(got.extended_regressor(),
                                  want.extended_regressor())


@pytest.mark.parametrize("ncomps,use_pca,flat", [(45, True, False),
                                                 (6, True, True),
                                                 (45, False, False)])
def test_mano_forward_matches_jax(ncomps, use_pca, flat):
    model = mano.synthetic_mano(0)
    rng = np.random.default_rng(7)
    pose = rng.normal(0, 0.5, (4, 3 + ncomps)).astype(np.float32)
    betas = rng.normal(0, 1, (4, 10)).astype(np.float32)
    trans = rng.normal(0, 0.1, (4, 3)).astype(np.float32)
    params = mano.ManoParams.from_model(model, ncomps, use_pca, flat,
                                        device="cpu")
    jparams = jmano.ManoParams.from_model(jmano.synthetic_mano(0), ncomps,
                                          use_pca, flat)
    for tr in (None, trans):
        verts, joints = mano.mano_forward(
            params, torch.from_numpy(pose), torch.from_numpy(betas),
            None if tr is None else torch.from_numpy(tr))
        jverts, jjoints = jmano.mano_forward(
            jparams, jnp.asarray(pose), jnp.asarray(betas),
            None if tr is None else jnp.asarray(tr))
        assert verts.shape == (4, 778, 3) and joints.shape == (4, 16, 3)
        _close(verts, jverts, 1e-5, "verts")
        _close(joints, jjoints, 1e-5, "joints")


def test_load_mano_pkl_matches_jax(tmp_path):
    """A MANO-layout pickle (10+ shape components, the kintree table, a
    sparse regressor) decodes to the same model in both packages."""
    m = jmano.synthetic_mano(1)
    raw = {"v_template": m.v_template,
           "shapedirs": np.concatenate([m.shapedirs, m.shapedirs], -1),
           "posedirs": m.posedirs,
           "J_regressor": sp.csc_matrix(m.j_regressor),
           "weights": m.weights, "f": m.faces.astype(np.uint32),
           "hands_components": m.hands_components,
           "hands_mean": m.hands_mean,
           "kintree_table": np.stack([np.array((4294967295,)
                                               + jmano.MANO_PARENTS[1:]),
                                      np.arange(16)])}
    path = str(tmp_path / "MANO_RIGHT.pkl")
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)
    got, want = mano.load_mano_pkl(path), jmano.load_mano_pkl(path)
    for fld in ("v_template", "shapedirs", "posedirs", "j_regressor",
                "weights", "faces", "hands_components", "hands_mean"):
        a, b = getattr(got, fld), getattr(want, fld)
        assert a.dtype == b.dtype, fld
        np.testing.assert_array_equal(a, b, fld)
    assert got.parents == want.parents == jmano.MANO_PARENTS
    np.testing.assert_array_equal(got.shapedirs, m.shapedirs)


# profiling

def test_step_timer(monkeypatch):
    clock = iter([10.0, 10.5, 11.5, 13.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(window=2)
    assert timer.mean_step_time == 0.0 and timer.throughput(8) == 0.0
    assert timer.tick() is None
    assert [timer.tick() for _ in range(3)] == [0.5, 1.0, 2.0]
    assert timer.mean_step_time == 1.5      # the window keeps the last two
    assert timer.throughput(3) == 2.0


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "aten::" in files[0].read_text()
    assert profiling.device_memory_stats() == {}
