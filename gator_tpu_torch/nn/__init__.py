from .attention import (BiasAttention, CrossAttention, MultiHeadedAttention,
                        attend)
from .fused_attention import (FusedAttention, fused_attention,
                              fused_attention_into, fused_attention_ref)
from .gat_trunk import fold_trunk_weights, gat_trunk, gat_trunk_ref
from .graph import MGCN, HopPathEncoding, XFeat
from .layers import (GraphLinear, Mlp, StdLayerNorm, layer_norm32,
                     std_layer_norm)
from .lbf_ablate import MODES, run_layers, run_layers_ref
from .lbf_layer import extract_layer_params, lbf_layer, lbf_layer_ref
from .lbf_stack import fold_stack_weights, lbf_stack, lbf_stack_ref

__all__ = [
    "BiasAttention", "CrossAttention", "FusedAttention", "GraphLinear",
    "HopPathEncoding", "MGCN", "MODES", "Mlp", "MultiHeadedAttention",
    "StdLayerNorm", "XFeat", "attend", "extract_layer_params",
    "fold_stack_weights", "fold_trunk_weights", "fused_attention",
    "fused_attention_into", "fused_attention_ref", "gat_trunk", "gat_trunk_ref", "layer_norm32",
    "lbf_layer", "lbf_layer_ref", "lbf_stack", "lbf_stack_ref",
    "run_layers", "run_layers_ref", "std_layer_norm",
]
