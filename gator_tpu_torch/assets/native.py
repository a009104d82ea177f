"""ctypes binding of the native graph-precompute library (counterpart of
gator_tpu/assets/native.py): Floyd-Warshall with its path matrix, the
per-hop edge features, and one Graclus heavy-edge-matching pass.

The library is built from the repo's source `native/graph_precompute.cc`
with `$CXX` (g++ by default) and the flags of `native/Makefile`, into
`build/native/libgator_precompute.so` at the root of the checkout (listed
in .gitignore; `BUILD_DIR`), on the first call that needs it (`build`,
`load_library` or an entry point) and never at import; a library older
than its source is rebuilt. `available()` says whether it is built, and
`use_native=None` in `graphs.build_graph_tables` and
`coarsening.build_coarse_graphs` uses it then. The numpy forms in
`graphs` and `coarsening` compute the same tables, and the tests hold the
two equal.
"""
from __future__ import annotations

import ctypes
import os
import os.path as osp
import shlex
import subprocess
import numpy as np

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
SOURCE = osp.join(ROOT, "native", "graph_precompute.cc")
BUILD_DIR = osp.join(ROOT, "build", "native")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

# library path -> the loaded library; filled on first use
_LOADED: dict = {}


def _library() -> str:
    return osp.join(BUILD_DIR, "libgator_precompute.so")


def _up_to_date(lib: str) -> bool:
    return osp.isfile(lib) and osp.getmtime(lib) >= osp.getmtime(SOURCE)


def build() -> str:
    """Compile `native/graph_precompute.cc` into
    `BUILD_DIR/libgator_precompute.so` unless it is up to date; -> its
    path. Raises with the compiler's message when the build fails. The
    library is written to a temporary file and renamed, so processes
    building at once do not race."""
    lib = _library()
    if _up_to_date(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cxx = shlex.split(os.environ.get("CXX", "g++"))
    try:
        proc = subprocess.run([*cxx, *CXXFLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"no C++ compiler for {SOURCE}: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx[0]} failed for {SOURCE}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, declaring each export's
    argument and result types."""
    path = build()
    if path not in _LOADED:
        lib = ctypes.CDLL(path)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.gator_floyd_warshall.restype = ctypes.c_int
        lib.gator_floyd_warshall.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, i32p, i32p]
        lib.gator_gen_edge_input.restype = None
        lib.gator_gen_edge_input.argtypes = [
            i32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
        lib.gator_hem_match.restype = ctypes.c_int
        lib.gator_hem_match.argtypes = [
            i32p, i32p, f32p, ctypes.c_int, i32p]
        _LOADED[path] = lib
    return _LOADED[path]


def available() -> bool:
    """Whether the library is built and up to date (as the JAX package's
    `available` asks whether `make -C native` ran); builds nothing."""
    return _up_to_date(_library())


def floyd_warshall(adjacency: np.ndarray, sentinel: int = 510):
    """All-pairs hops and the path matrix; raises if the graph is
    disconnected (the contract of graphs.floyd_warshall)."""
    lib = load_library()
    off = np.array(adjacency, np.float32)
    np.fill_diagonal(off, 0.0)
    n = off.shape[0]
    dist = np.empty((n, n), np.int32)
    path = np.empty((n, n), np.int32)
    if lib.gator_floyd_warshall(off, n, sentinel, dist, path):
        raise ValueError("joint graph is disconnected; hop tables undefined")
    return dist, path


def gen_edge_input(max_dist: int, path: np.ndarray,
                   edge_feat: np.ndarray, sentinel: int = 510):
    """Per-hop edge features [n, n, max_dist] along each shortest path
    (graphs.gen_edge_input)."""
    lib = load_library()
    n = path.shape[0]
    out = np.empty((n, n, max_dist), np.float32)
    lib.gator_gen_edge_input(
        np.ascontiguousarray(path, np.int32),
        np.ascontiguousarray(edge_feat, np.float32),
        n, max_dist, sentinel, out)
    return out


def hem_match(w_csr) -> np.ndarray:
    """One Graclus HEM pass over a symmetric scipy CSR matrix -> cluster
    ids (coarsening.heavy_edge_matching with the degree `coarsen`
    passes: the row sums)."""
    lib = load_library()
    n = w_csr.shape[0]
    cluster = np.empty(n, np.int32)
    lib.gator_hem_match(
        np.ascontiguousarray(w_csr.indptr, np.int32),
        np.ascontiguousarray(w_csr.indices, np.int32),
        np.ascontiguousarray(w_csr.data, np.float32),
        n, cluster)
    return cluster.astype(np.int64)
