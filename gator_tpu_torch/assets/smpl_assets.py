"""SMPL model-parameter assets.

Loads the standard SMPL pickle files (``basicModel_*_lbs_10_207_0_v1.0.0.pkl``)
into plain numpy arrays without requiring the ``chumpy`` package — the
reference relies on chumpy-aware unpickling
(reference: smplpytorch/smplpytorch/native/webuser/serialization.py:1-39).

Also provides a deterministic *synthetic* SMPL-like model so the entire
framework (models, losses, training, eval) is testable without the external
SMPL downloads (gap noted in SURVEY.md §4/§7).
"""
from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, Dict

import numpy as np

VERTEX_NUM = 6890
JOINT_NUM = 24
POSE_BLEND_DIM = 207   # 23 joints x 9 rotmat entries
SHAPE_DIM = 10

# SMPL kinematic parents (kintree_table row 0; parent of root is itself here).
KINTREE_PARENTS = (
    0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)


@dataclasses.dataclass(frozen=True)
class SmplModel:
    """Plain-numpy SMPL parameters for one gender."""

    v_template: np.ndarray    # [V, 3]
    shapedirs: np.ndarray     # [V, 3, 10]
    posedirs: np.ndarray      # [V, 3, 207]
    j_regressor: np.ndarray   # [24, V] (dense)
    weights: np.ndarray       # [V, 24] LBS skinning weights
    faces: np.ndarray         # [F, 3] int32
    kintree_parents: tuple = KINTREE_PARENTS
    # model mean shape; substituted when a sample's betas are zeroed
    # (reference: smpl_layer.py:40-41,87-95)
    mean_betas: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(SHAPE_DIM, np.float32))

    @property
    def vertex_num(self) -> int:
        return self.v_template.shape[0]


class _ChumpyShim:
    """Stands in for chumpy.Ch during unpickling; keeps only the ndarray."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def r(self):
        for key in ("x", "_data", "a"):
            val = self.__dict__.get(key)
            if isinstance(val, np.ndarray):
                return val
            if isinstance(val, _ChumpyShim):
                return val.r
        raise AttributeError("no array payload found in chumpy object")


class _SmplUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        return super().find_class(module, name)


def _to_array(val: Any) -> Any:
    if isinstance(val, _ChumpyShim):
        return np.asarray(val.r)
    if hasattr(val, "toarray"):  # scipy sparse
        return np.asarray(val.toarray())
    return val


def load_smpl_pkl(path: str) -> SmplModel:
    """Decode a standard SMPL pkl into a SmplModel (chumpy-free)."""
    with open(path, "rb") as f:
        raw: Dict[str, Any] = _SmplUnpickler(
            io.BytesIO(f.read()), encoding="latin1").load()
    data = {k: _to_array(v) for k, v in raw.items()}
    parents = tuple(int(p) for p in np.asarray(data["kintree_table"])[0])
    # root parent is stored as uint32(-1); clamp to 0 (root maps to itself)
    parents = (0,) + parents[1:]
    return SmplModel(
        v_template=np.asarray(data["v_template"], np.float32),
        shapedirs=np.asarray(data["shapedirs"], np.float32)[..., :SHAPE_DIM],
        posedirs=np.asarray(data["posedirs"], np.float32),
        j_regressor=np.asarray(data["J_regressor"], np.float32),
        weights=np.asarray(data["weights"], np.float32),
        faces=np.asarray(data["f"], np.int32),
        kintree_parents=parents,
        mean_betas=np.asarray(
            data.get("betas", np.zeros(SHAPE_DIM)), np.float32).reshape(-1),
    )


# ---------------------------------------------------------------------------
# synthetic model (deterministic, for tests / asset-free development)
# ---------------------------------------------------------------------------

# Rough humanoid rest-pose joint positions [24, 3] (x right, y up, z forward),
# meters. Only used to make the synthetic model geometrically plausible.
_REST_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.09, -0.06, 0.00],   # 1 L hip
    [-0.09, -0.06, 0.00],  # 2 R hip
    [0.00, 0.11, 0.00],    # 3 torso
    [0.10, -0.45, 0.00],   # 4 L knee
    [-0.10, -0.45, 0.00],  # 5 R knee
    [0.00, 0.25, 0.00],    # 6 spine
    [0.09, -0.85, -0.02],  # 7 L ankle
    [-0.09, -0.85, -0.02], # 8 R ankle
    [0.00, 0.31, 0.00],    # 9 chest
    [0.11, -0.92, 0.10],   # 10 L toe
    [-0.11, -0.92, 0.10],  # 11 R toe
    [0.00, 0.48, 0.00],    # 12 neck
    [0.07, 0.38, 0.00],    # 13 L thorax
    [-0.07, 0.38, 0.00],   # 14 R thorax
    [0.00, 0.58, 0.02],    # 15 head
    [0.17, 0.42, 0.00],    # 16 L shoulder
    [-0.17, 0.42, 0.00],   # 17 R shoulder
    [0.43, 0.40, 0.00],    # 18 L elbow
    [-0.43, 0.40, 0.00],   # 19 R elbow
    [0.68, 0.40, 0.00],    # 20 L wrist
    [-0.68, 0.40, 0.00],   # 21 R wrist
    [0.76, 0.40, 0.00],    # 22 L hand
    [-0.76, 0.40, 0.00],   # 23 R hand
], dtype=np.float32)


def synthetic_smpl(vertex_num: int = VERTEX_NUM, seed: int = 0) -> SmplModel:
    """Deterministic SMPL-like model: vertices scattered around the rest
    skeleton, soft distance-based skinning weights, nearest-vertex joint
    regressor, small random blend shapes, random (non-manifold) faces.

    Geometry is plausible enough for shape/metric/loss tests; it is NOT the
    licensed SMPL body.
    """
    rng = np.random.default_rng(seed)
    # scatter vertices around the bones
    parents = np.asarray(KINTREE_PARENTS)
    bone_of_vertex = rng.integers(1, JOINT_NUM, size=vertex_num)
    t = rng.uniform(0.0, 1.0, size=(vertex_num, 1)).astype(np.float32)
    a = _REST_JOINTS[parents[bone_of_vertex]]
    b = _REST_JOINTS[bone_of_vertex]
    v_template = (a + t * (b - a)
                  + rng.normal(0, 0.04, size=(vertex_num, 3))).astype(
                      np.float32)

    # soft skinning weights from inverse distance to joints (top-4 sparse-ish)
    d2 = ((v_template[:, None, :] - _REST_JOINTS[None]) ** 2).sum(-1)
    w = 1.0 / (d2 + 1e-3)
    # keep top 4 influences per vertex like real SMPL
    thresh = np.sort(w, axis=1)[:, -4][:, None]
    w = np.where(w >= thresh, w, 0.0)
    weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # joint regressor: inverse-distance weights over the 16 nearest vertices
    jr = 1.0 / (d2.T + 1e-3)  # [24, V]
    thresh_j = np.sort(jr, axis=1)[:, -16][:, None]
    jr = np.where(jr >= thresh_j, jr, 0.0)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = rng.normal(
        0, 0.01, size=(vertex_num, 3, SHAPE_DIM)).astype(np.float32)
    posedirs = rng.normal(
        0, 0.001, size=(vertex_num, 3, POSE_BLEND_DIM)).astype(np.float32)

    if vertex_num < 3:
        raise ValueError(
            f"vertex_num={vertex_num}: a triangle mesh needs >= 3 "
            "distinct vertices")
    face_num = 2 * vertex_num - 4 if vertex_num >= 4 else 1
    faces = rng.integers(0, vertex_num, size=(face_num, 3)).astype(np.int32)
    # avoid degenerate faces with repeated indices
    while True:
        bad1 = faces[:, 1] == faces[:, 0]
        faces[:, 1] = np.where(bad1, (faces[:, 1] + 1) % vertex_num,
                               faces[:, 1])
        bad2 = (faces[:, 2] == faces[:, 0]) | (faces[:, 2] == faces[:, 1])
        faces[:, 2] = np.where(bad2, (faces[:, 2] + 1) % vertex_num,
                               faces[:, 2])
        if not (bad1.any() or bad2.any()):
            break

    return SmplModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        weights=weights,
        faces=faces,
    )
