"""Asset bundle: every static table the models/losses/eval need, assembled
once ahead of time into plain numpy arrays (models register them as
buffers — no scattered file loads inside the model constructors, as the
reference has).

Resolution order for each asset: explicit override > file in a data dir
(same filenames/layout as the reference's `data/` tree) > derived from the
SMPL model > deterministic synthetic stand-in.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Optional

import numpy as np

from ..profiling import span
from . import graphs, mesh_sampling, skeletons, smpl_assets


@dataclasses.dataclass(frozen=True)
class GatorAssets:
    """Static tables for one (joint set, body model) configuration."""

    joint_set: skeletons.JointSet
    graph: graphs.GraphTables                 # GAT attention-bias tables
    mean_vertices: np.ndarray                 # [V0, 3] template/mean mesh
    template_joints: np.ndarray               # [J, 3] joints of mean mesh
    init_verts_coarse: np.ndarray             # [V2, 3] (431 for real SMPL)
    vj_relation: np.ndarray                   # [V2] nearest h36m joint idx
    j_regressor_h36m: np.ndarray              # [17, V0]
    j_regressor_coco: np.ndarray              # [17, V0]
    j_regressor_smpl: np.ndarray              # [24, V0]
    faces: np.ndarray                         # [F, 3] int32
    sampling: mesh_sampling.MeshSampling
    smpl: smpl_assets.SmplModel               # neutral body model
    smpl_gendered: dict                       # gender -> SmplModel

    @property
    def joint_num(self) -> int:
        return self.joint_set.joint_num


def _find(data_dirs, *relpaths) -> Optional[str]:
    for d in data_dirs:
        for rel in relpaths:
            p = osp.join(d, rel)
            if osp.isfile(p):
                return p
    return None


def default_data_dirs() -> list[str]:
    dirs = []
    env = os.environ.get("GATOR_DATA_DIR")
    if env:
        dirs.append(env)
    dirs.append(osp.join(os.getcwd(), "data"))
    return dirs


def build_assets(
    input_joint_set: str = "human36",
    data_dirs: Optional[list[str]] = None,
    smpl_model: Optional[smpl_assets.SmplModel] = None,
    synthetic_vertex_num: int = smpl_assets.VERTEX_NUM,
    seed: int = 0,
) -> GatorAssets:
    """Assemble all assets for one configuration.

    data_dirs: directories searched for the reference data layout
    (`base_data/smpl_mean_vertices.npy`, `base_data/mesh_downsampling.npz`,
    `Human36M/J_regressor_h36m_correct.npy`, `COCO/J_regressor_coco.npy`,
    SMPL pkls under `smpl/` or `base_data/`). Anything missing falls back to
    the synthetic stand-ins. Runs in the set-up span setup.assets.
    """
    with span("setup.assets", always=True):
        return _assemble(input_joint_set, data_dirs, smpl_model,
                         synthetic_vertex_num, seed)


def _assemble(input_joint_set, data_dirs, smpl_model, synthetic_vertex_num,
              seed) -> GatorAssets:
    data_dirs = data_dirs if data_dirs is not None else default_data_dirs()
    jset = skeletons.get_joint_set(input_joint_set)

    # --- body model -------------------------------------------------------
    gendered: dict[str, smpl_assets.SmplModel] = {}
    if smpl_model is None:
        for gender, stem in (("neutral", "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"),
                             ("female", "basicModel_f_lbs_10_207_0_v1.0.0.pkl"),
                             ("male", "basicModel_m_lbs_10_207_0_v1.0.0.pkl")):
            p = _find(data_dirs, osp.join("smpl", stem),
                      osp.join("base_data", stem), stem)
            if p:
                gendered[gender] = smpl_assets.load_smpl_pkl(p)
        smpl_model = gendered.get("neutral")
    if smpl_model is None:
        smpl_model = smpl_assets.synthetic_smpl(synthetic_vertex_num, seed)
    gendered.setdefault("neutral", smpl_model)
    gendered.setdefault("female", smpl_model)
    gendered.setdefault("male", smpl_model)
    v0 = smpl_model.vertex_num

    # --- mean mesh --------------------------------------------------------
    p = _find(data_dirs, osp.join("base_data", "smpl_mean_vertices.npy"))
    if p:
        mean_vertices = np.load(p).astype(np.float32)
    else:
        mean_vertices = smpl_model.v_template.astype(np.float32)

    # --- joint regressors -------------------------------------------------
    p = _find(data_dirs, osp.join("Human36M", "J_regressor_h36m_correct.npy"),
              osp.join("base_data", "J_regressor_h36m.npy"))
    if p:
        j_reg_h36m = np.load(p).astype(np.float32)
    else:
        # synthetic 17-joint regressor: h36m joints as linear combos of the
        # 24 smpl joints (rough correspondence), so shapes/geometry are sane
        j_reg_h36m = _synthetic_h36m_regressor(smpl_model)
    p = _find(data_dirs, osp.join("COCO", "J_regressor_coco.npy"))
    if p:
        j_reg_coco = np.load(p).astype(np.float32)
    else:
        j_reg_coco = _synthetic_coco_regressor(smpl_model)
    assert j_reg_h36m.shape[1] == v0 and j_reg_coco.shape[1] == v0

    # --- mesh resampling --------------------------------------------------
    p = _find(data_dirs, osp.join("base_data", "mesh_downsampling.npz"))
    if p:
        sampling = mesh_sampling.load_mesh_sampling_npz(p)
    else:
        sampling = mesh_sampling.synthetic_mesh_sampling(v0)
    init_verts_coarse = sampling.downsample(mean_vertices).astype(np.float32)

    # --- GAT graph tables (template joints in the *input* joint set) ------
    # template joints = J_regressor @ mean mesh; coco appends pelvis & neck
    # (reference: lib/models/GAT.py:74-93)
    if jset.name == "coco":
        base = j_reg_coco @ mean_vertices
        lhip, rhip = (jset.joints_name.index("L_Hip"),
                      jset.joints_name.index("R_Hip"))
        lsho, rsho = (jset.joints_name.index("L_Shoulder"),
                      jset.joints_name.index("R_Shoulder"))
        pelvis = 0.5 * (base[lhip] + base[rhip])
        neck = 0.5 * (base[lsho] + base[rsho])
        template_joints = np.concatenate(
            [base, pelvis[None], neck[None]], axis=0)
    else:
        template_joints = j_reg_h36m @ mean_vertices
    graph = graphs.build_graph_tables(
        skeletons.gat_adjacency(jset), template_joints)

    # --- MDR vertex->joint relation (always vs the 17 h36m template joints,
    # reference: lib/models/MDR.py:85-87) -----------------------------------
    h36m_template = j_reg_h36m @ mean_vertices
    vj_relation = graphs.nearest_joint_assignment(
        h36m_template, init_verts_coarse)

    return GatorAssets(
        joint_set=jset,
        graph=graph,
        mean_vertices=mean_vertices,
        template_joints=template_joints.astype(np.float32),
        init_verts_coarse=init_verts_coarse,
        vj_relation=vj_relation,
        j_regressor_h36m=j_reg_h36m,
        j_regressor_coco=j_reg_coco,
        j_regressor_smpl=smpl_model.j_regressor.astype(np.float32),
        faces=smpl_model.faces.astype(np.int32),
        sampling=sampling,
        smpl=smpl_model,
        smpl_gendered=gendered,
    )


# h36m joint -> weights over smpl joints (approximate, synthetic-only)
_H36M_FROM_SMPL = {
    0: {0: 1.0},                      # pelvis
    1: {2: 1.0}, 2: {5: 1.0}, 3: {8: 1.0},     # R hip/knee/ankle
    4: {1: 1.0}, 5: {4: 1.0}, 6: {7: 1.0},     # L hip/knee/ankle
    7: {3: 0.5, 6: 0.5},              # torso
    8: {12: 1.0},                     # neck
    9: {15: 0.7, 12: 0.3},            # nose
    10: {15: 1.0},                    # head
    11: {16: 1.0}, 12: {18: 1.0}, 13: {20: 1.0},  # L sho/elb/wri
    14: {17: 1.0}, 15: {19: 1.0}, 16: {21: 1.0},  # R sho/elb/wri
}

_COCO_FROM_SMPL = {
    0: {15: 1.0}, 1: {15: 1.0}, 2: {15: 1.0}, 3: {15: 1.0}, 4: {15: 1.0},
    5: {16: 1.0}, 6: {17: 1.0}, 7: {18: 1.0}, 8: {19: 1.0},
    9: {20: 1.0}, 10: {21: 1.0}, 11: {1: 1.0}, 12: {2: 1.0},
    13: {4: 1.0}, 14: {5: 1.0}, 15: {7: 1.0}, 16: {8: 1.0},
}


def _combo_regressor(mapping, rows, smpl_model):
    reg = np.zeros((rows, smpl_model.vertex_num), dtype=np.float32)
    for out_j, combo in mapping.items():
        for smpl_j, w in combo.items():
            reg[out_j] += w * smpl_model.j_regressor[smpl_j]
    return reg


def _synthetic_h36m_regressor(smpl_model) -> np.ndarray:
    return _combo_regressor(_H36M_FROM_SMPL, 17, smpl_model)


def _synthetic_coco_regressor(smpl_model) -> np.ndarray:
    return _combo_regressor(_COCO_FROM_SMPL, 17, smpl_model)
