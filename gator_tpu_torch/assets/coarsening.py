"""Multilevel graph coarsening (Graclus heavy-edge matching) + Laplacians
(counterpart of gator_tpu/assets/coarsening.py, a copy; reference:
lib/coarsening.py:43-322 and lib/graph_utils.py:37-112):
`build_coarse_graphs` produces the per-level adjacencies, rescaled
normalized Laplacians, and the binary-tree vertex permutation (with fake
singleton nodes) that makes pooling a reshape. The GAT model itself only
consumes the joint adjacency (SURVEY.md §2.2 note), but the full pipeline
is provided for downstream graph-conv work.

Implementation is numpy/scipy-free-form (dense for the joint graph, scipy
sparse for mesh-scale graphs) and deterministic: vertices are visited in
increasing-degree order like the reference (coarsening.py:93-94).
`use_native` runs each matching pass in the C++ library
(`native.hem_match`), which gives the same clusters.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from . import native


def build_mesh_graph(faces: np.ndarray, num_vertex: int) -> sp.csr_matrix:
    """Symmetric binary adjacency from triangle faces
    (reference: lib/graph_utils.py:37-57)."""
    edges = np.concatenate([faces[:, :2], faces[:, 1:], faces[:, ::2]])
    adj = sp.coo_matrix(
        (np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
        shape=(num_vertex, num_vertex), dtype=np.float32)
    adj = adj.tocsr()
    adj.data[:] = 1.0
    adj = adj.maximum(adj.T)
    adj.setdiag(0)
    adj.eliminate_zeros()
    return adj


def heavy_edge_matching(w: sp.csr_matrix,
                        degree: np.ndarray | None = None) -> np.ndarray:
    """One Graclus/HEM pass, mirroring the reference's ENABLED scoring
    (the "second approach", coarsening.py:186-197):
        score(v, u) = (2 W_vu + W_vv + W_uu) / (d_v + d_u + 1e-9)
    where W_ii is the FIRST STORED value of row i (the reference indexes
    vv[rowstart[i]] — a quirk preserved deliberately), `degree` is the
    caller-supplied Graclus weight vector (reference HEM passes colsum
    minus the diagonal at level 0 and plain colsum afterwards,
    coarsening.py:95-148), and a neighbor only wins with a strictly
    positive score (wmax starts at 0). Visit order = increasing column
    sum (reference: rid = argsort(W.sum(axis=0))). Returns cluster ids.
    """
    w = sp.csr_matrix(w)
    n = w.shape[0]
    colsum = np.asarray(w.sum(axis=0)).ravel()
    # float64, as the reference's numpy computed the score (under NEP 50 a
    # float32 degree would round d_v + d_u + 1e-9 to float32)
    degree = np.asarray(colsum if degree is None else degree, np.float64)
    order = np.argsort(colsum, kind="stable")
    indptr, indices, data = w.indptr, w.indices, w.data
    first_val = np.zeros(n)
    has_row = indptr[1:] > indptr[:-1]
    first_val[has_row] = data[indptr[:-1][has_row]]
    matched = np.zeros(n, dtype=bool)
    cluster = np.full(n, -1, dtype=np.int64)
    cid = 0
    for v in order:
        if matched[v]:
            continue
        matched[v] = True          # before the scan: self-loops skip
        best, best_w = -1, 0.0
        for k in range(indptr[v], indptr[v + 1]):
            u = indices[k]
            if matched[u]:
                continue
            score = (2.0 * data[k] + first_val[v] + first_val[u]) \
                / (degree[v] + degree[u] + 1e-9)
            if score > best_w:
                best_w, best = score, u
        cluster[v] = cid
        if best >= 0:
            matched[best] = True
            cluster[best] = cid
        cid += 1
    return cluster


def _coarsen_one(w: sp.csr_matrix, degree: np.ndarray,
                 use_native: bool) -> Tuple[sp.csr_matrix, np.ndarray]:
    """One coarsening level. Intra-cluster edges accumulate on the coarse
    DIAGONAL (self-loops kept, exactly like the reference HEM loop,
    coarsening.py:124-135 — they feed the next level's degrees and
    Wii terms)."""
    # the library takes the row sums as the degree, which is `coarsen`'s
    # on these symmetric graphs (level 0 has an empty diagonal)
    cluster = (native.hem_match(w) if use_native
               else heavy_edge_matching(w, degree))
    n_coarse = int(cluster.max()) + 1
    coo = w.tocoo()
    wc = sp.csr_matrix(
        (coo.data, (cluster[coo.row], cluster[coo.col])),
        shape=(n_coarse, n_coarse))
    wc.eliminate_zeros()
    return wc, cluster


def compute_perm(parents: List[np.ndarray]) -> List[np.ndarray]:
    """Binary-tree orderings so each coarse vertex's (up to two) children
    sit at consecutive fine indices; singletons get fake children
    (reference: lib/coarsening.py:214-262)."""
    if not parents:
        return []
    n_coarsest = int(parents[-1].max()) + 1
    indices = [np.arange(n_coarsest)]
    for parent in parents[::-1]:
        indices_layer = []
        fake = len(parent)   # fake nodes appended after the real ones
        pool_singletons = list(indices[-1])
        for i in pool_singletons:
            children = list(np.nonzero(parent == i)[0])
            while len(children) < 2:
                children.append(fake)
                fake += 1
            indices_layer.extend(children)
        indices.append(np.array(indices_layer))
    return indices[::-1]


def perm_adjacency(w: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """Extend W with zero-degree fake vertices and permute
    (reference: lib/coarsening.py:265-292)."""
    n = w.shape[0]
    n_new = len(perm)
    if n_new > n:
        pad = sp.csr_matrix((n_new - n, n), dtype=w.dtype)
        w = sp.vstack([w, pad]).tocsc()
        pad = sp.csc_matrix((n_new, n_new - n), dtype=w.dtype)
        w = sp.hstack([w, pad]).tocsr()
    # new[i, j] = old[perm[i], perm[j]] — the reference maps old row r to
    # new row argsort(indices)[r], i.e. new = old[indices][:, indices]
    # (coarsening.py:281-284); the binary-tree slots (2i, 2i+1) then hold
    # the children listed by compute_perm
    perm = np.asarray(perm)
    return sp.csr_matrix(w[perm][:, perm])


def perm_index_reverse(perm: np.ndarray) -> np.ndarray:
    """Fine-level indices of the original vertices after permutation
    (reference: lib/coarsening.py:322)."""
    return np.argsort(np.asarray(perm))


def laplacian(w, normalized: bool = True):
    """(Normalized) graph Laplacian (reference: lib/coarsening.py:6-25)."""
    w = sp.csr_matrix(w)
    d = np.asarray(w.sum(axis=0)).ravel()
    if not normalized:
        return (sp.diags(d) - w).tocsr()
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    d_inv_sqrt[d == 0] = 0
    dm = sp.diags(d_inv_sqrt)
    eye = sp.identity(w.shape[0], dtype=w.dtype)
    return (eye - dm @ w @ dm).tocsr()


def lmax_l(lap) -> float:
    """Largest Laplacian eigenvalue (reference: lib/coarsening.py:37-40)."""
    from scipy.sparse.linalg import eigsh
    if lap.shape[0] <= 2:
        return float(np.linalg.eigvalsh(lap.toarray()).max())
    # a seeded start vector: ARPACK's own is random, and the rescaled
    # Laplacians would move in their last bits from run to run
    v0 = np.random.default_rng(0).uniform(size=lap.shape[0])
    return float(eigsh(lap, k=1, which="LM", v0=v0,
                       return_eigenvectors=False)[0])


def rescale_l(lap, lmax: float, scale: float = 1.0):
    """L <- 2 scale/lmax * L - I (reference: lib/coarsening.py:28-34)."""
    eye = sp.identity(lap.shape[0], format="csr", dtype=lap.dtype)
    return (lap * (2.0 * scale / lmax)) - eye


def coarsen(adj: sp.spmatrix, levels: int,
            use_native: bool | None = None):
    """Multilevel coarsening: levels+1 (permuted) adjacencies + the
    level-0 vertex permutation (reference: lib/coarsening.py:43-64).
    Degree handling follows the reference's HEM loop: level 0 uses
    colsum minus the diagonal, later levels plain colsum (self-loops
    included, coarsening.py:95-148); the coarsest graph is left
    unpermuted (reference: `if i < levels`). `use_native`: the matching
    in the C++ library; None uses it where it is built."""
    if use_native is None:
        use_native = native.available()
    w = sp.csr_matrix(adj)
    graphs = [w]
    parents = []
    degree = np.asarray(w.sum(axis=0)).ravel() - w.diagonal()
    for _ in range(levels):
        w, cluster = _coarsen_one(w, degree, use_native)
        parents.append(cluster)
        graphs.append(w)
        degree = np.asarray(w.sum(axis=0)).ravel()
    perms = compute_perm(parents)
    graphs_out = []
    for i, g in enumerate(graphs):
        if i < levels:
            g = perm_adjacency(g, perms[i])
        g = g.tocsr()
        g.eliminate_zeros()
        graphs_out.append(g)
    return graphs_out, perms[0] if perms else np.arange(w.shape[0])


def build_coarse_graphs(mesh_faces: np.ndarray, joint_adjacency: np.ndarray,
                        levels: int = 9, use_native: bool | None = None):
    """Full reference pipeline: coarsen the mesh graph `levels` times, then
    REPLACE the coarsest level with the joint graph
    (reference: lib/graph_utils.py:92-112). Returns levels+1 entries —
    mesh levels 0..levels-1 plus the joint graph — with only the MESH
    Laplacians rescaled (the reference's `for i in range(levels)` leaves
    the joint Laplacian raw-normalized).
    `use_native` as in `coarsen`.
    Returns (adjacencies, laplacians, perm, perm_reverse)."""
    num_vertex = int(mesh_faces.max()) + 1
    mesh_adj = build_mesh_graph(mesh_faces, num_vertex)
    graphs, perm0 = coarsen(mesh_adj, levels, use_native)

    joint = sp.csr_matrix(np.asarray(joint_adjacency, np.float32))
    joint.eliminate_zeros()
    adjacencies = graphs[:levels] + [joint]
    laplacians = []
    for g in adjacencies[:levels]:
        lap = laplacian(g, normalized=True)
        laplacians.append(rescale_l(lap, lmax_l(lap)))
    laplacians.append(laplacian(joint, normalized=True))
    return adjacencies, laplacians, perm0, perm_index_reverse(perm0)
