from .attention import (BiasAttention, CrossAttention, MultiHeadedAttention,
                        attend)
from .fused_attention import (FusedAttention, fused_attention,
                              fused_attention_ref)
from .gat_trunk import fold_trunk_weights, gat_trunk, gat_trunk_ref
from .graph import MGCN, HopPathEncoding, XFeat
from .layers import (GraphLinear, Mlp, StdLayerNorm, layer_norm32,
                     std_layer_norm)
from .lbf_stack import fold_stack_weights, lbf_stack, lbf_stack_ref

__all__ = [
    "BiasAttention", "CrossAttention", "FusedAttention", "GraphLinear",
    "HopPathEncoding", "MGCN", "Mlp", "MultiHeadedAttention", "StdLayerNorm",
    "XFeat", "attend", "fold_stack_weights", "fold_trunk_weights",
    "fused_attention", "fused_attention_ref",
    "gat_trunk", "gat_trunk_ref", "layer_norm32", "lbf_stack",
    "lbf_stack_ref", "std_layer_norm",
]
