from .gat import GAT, GATBlock, GatSpec
from .gator import GATOR, GatorSpec, build_gat, build_gator, init_gator_
from .mdr import MDR, MdrSpec, conv1d_len3

__all__ = ["GAT", "GATBlock", "GATOR", "GatSpec", "GatorSpec", "MDR",
           "MdrSpec", "build_gat", "build_gator", "conv1d_len3",
           "init_gator_"]
