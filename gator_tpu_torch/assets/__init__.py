from . import graphs, mesh_sampling, skeletons, smpl_assets
from .bundle import GatorAssets, build_assets, default_data_dirs
from .graphs import GraphTables, build_graph_tables
from .mesh_sampling import MeshSampling
from .skeletons import COCO, H36M, SMPL24, JointSet, get_joint_set
from .smpl_assets import SmplModel, load_smpl_pkl, synthetic_smpl

__all__ = [
    "COCO", "H36M", "SMPL24", "GatorAssets", "GraphTables", "JointSet",
    "MeshSampling", "SmplModel", "build_assets", "build_graph_tables",
    "default_data_dirs", "get_joint_set", "graphs", "load_smpl_pkl",
    "mesh_sampling", "skeletons", "smpl_assets", "synthetic_smpl",
]
