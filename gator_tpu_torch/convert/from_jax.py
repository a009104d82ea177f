"""Weights from the JAX package's flax variables into the port's state dict.

The key rules are those of the reference-checkpoint converter
(gator_tpu/convert/torch_loader.py:20-61), restated here because the port
imports nothing of the JAX package:
  * a TorchDense `<mod>/linear/{kernel,bias}` is torch `<mod>.{weight,bias}`
    with the kernel transposed ([in, out] -> [out, in]);
  * `scale` (LayerNorm / GroupNorm / BatchNorm) is `weight`;
  * `GLinear_i`, `blocks_i`, `linears_i` are the ModuleList entries `.i`;
  * embedding tables are `<table>.weight`;
  * batch_stats `mean` / `var` are `running_mean` / `running_var`; a torch
    BatchNorm also carries `num_batches_tracked`, set to 0.
Everything else (W, b, M, adj2, bias, weight, a_2, b_2) carries over as is.

`layer_weights_from_jax` packs one LBF layer in the JAX package's
per-layer form (gator_tpu/nn/pallas_mdr.py:35 `LAYER_PARAM_KEYS`) for the
layer kernels, so that a test can feed both packages the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..nn import cuda_lib
from ..nn.lbf_layer import pack_layer

_INDEXED = ("GLinear", "blocks", "linears")
_EMBED_LEAVES = ("pos_id_embed", "pos_num_embed", "pos_j_id_embed",
                 "pos_v_id_embed", "spatial_pos_encoder")


def _module_path(path: Tuple[str, ...]) -> str:
    parts = []
    for name in path:
        for base in _INDEXED:
            idx = name[len(base) + 1:]
            if name.startswith(base + "_") and idx.isdigit():
                name = f"{base}.{idx}"
                break
        parts.append(name)
    return ".".join(parts)


def _key(path: Tuple[str, ...], leaf: str,
         collection: str) -> Tuple[str, bool]:
    """-> (torch key, whether the value is transposed)."""
    if collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        return f"{_module_path(path)}.{name}", False
    if path and path[-1] == "linear":
        mod = _module_path(path[:-1])
        return (f"{mod}.weight", True) if leaf == "kernel" \
            else (f"{mod}.bias", False)
    mod = _module_path(path)
    prefix = f"{mod}." if mod else ""
    if leaf == "scale":
        return f"{prefix}weight", False
    if leaf in _EMBED_LEAVES:
        return f"{prefix}{leaf}.weight", False
    return f"{prefix}{leaf}", False


def _walk(tree: Dict[str, Any], path=()) -> Iterator:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        else:
            yield path, key, val


def state_dict_from_jax(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """flax variables ({'params': ..., 'batch_stats': ...}, leaves as numpy
    arrays) -> the port's state dict, loadable with strict=True. A gradient
    tree of the params converts by the same names and transposes
    (`state_dict_from_jax({'params': grads})`), so gradients compare by
    name with the port's `param.grad`."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf, val in _walk(tree):
            key, transpose = _key(path, leaf, collection)
            arr = np.array(val, dtype=np.float32)
            out[key] = torch.from_numpy(arr.T.copy() if transpose else arr)
            if collection == "batch_stats" and leaf == "mean":
                bn = key[:-len("running_mean")]
                out[bn + "num_batches_tracked"] = torch.tensor(0)
    return out


def layer_weights_from_jax(layer_params: Dict[str, Any], dtype: torch.dtype,
                           device) -> cuda_lib.Packed:
    """One LBF layer's JAX parameter dict (`LAYER_PARAM_KEYS`, numpy
    arrays; matrices already [in, out], so nothing is transposed) -> the
    port's packed one-layer weights (norm1/norm2 scale and bias become
    ln1/ln2 weight and bias)."""
    return pack_layer({k: torch.from_numpy(np.array(v, dtype=np.float32))
                       for k, v in layer_params.items()}, dtype, device)
