from .gat import GAT, GATBlock, GatSpec
from .gator import GATOR, GatorSpec, build_gat, build_gator, init_gator_
from .hmr2 import HMR2, Hmr2Spec, build_hmr2
from .mdr import MDR, MdrSpec, conv1d_len3
from .motionbert import MeshRegressor, MotionBertSpec, build_motionbert_mesh

__all__ = ["GAT", "GATBlock", "GATOR", "GatSpec", "GatorSpec", "HMR2",
           "Hmr2Spec", "MDR", "MdrSpec", "MeshRegressor", "MotionBertSpec",
           "build_gat", "build_gator", "build_hmr2", "build_motionbert_mesh",
           "conv1d_len3", "init_gator_"]
