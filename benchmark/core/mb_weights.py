"""MotionBERT's mesh-model weights, made by the benchmark on the card from
the seed (the rules of core/weights.py do not name its parameters).

As there: one uniform and one normal draw of a torch.Generator on the
device, cut into the parameters by name (MotionBERT's state-dict keys),
and both the program and the plain reference are handed the same tensors.

The distributions are MotionBERT's initialisation (DSTformer.py
`_init_weights`: trunc-normal 0.02 linears and embeddings; model_mesh.py:
torch's default fc1/fc2, xavier head_pose/head_shape), with departures
that keep a check able to see a fault:
  * the backbone's linear biases are drawn around 0 (they start at 0);
  * head_pose and head_shape are drawn at xavier gain HEAD_GAIN (1), not
    0.01, so that the predicted 6D rotations move by about 0.1 across
    frames and 0.2 from init_pose (at 0.01 the mesh hardly depends on the
    input; at 2 the Gram-Schmidt meets near-parallel columns, and a
    bf16 rounding there turns a joint by tens of centimetres);
  * ts_attn, the per-token gate of the two streams, is drawn around its
    0.5 bias with weights of the linears' 0.02, not zero;
  * LayerNorm and BatchNorm scales and shifts and BatchNorm's running
    statistics are drawn around their constants;
  * init_pose and init_shape, which stand for smpl_mean_params.npz (a
    download), are drawn around the rest pose (6D, SPIN layout) and 0.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch

HEAD_GAIN = 1.0
REST_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)

_NORM = re.compile(r"(\.norm|norm[12]_[st]|bn[12])\.(weight|bias)$")
_EMBED = re.compile(r"(temp_embed|pos_embed)$")


def _xavier(shape) -> float:
    fan_out, fan_in = shape
    return math.sqrt(6.0 / (fan_in + fan_out))


def rule(name: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple]
         ) -> Tuple[str, object, float]:
    """-> (draw, centre, half-width): uniform draws give centre +
    half-width * U(-1, 1), normal draws centre + half-width * N(0, 1); a
    centre is a number or a tuple over the last dimension."""
    if name.endswith("running_mean"):
        return "u", 0.0, 0.1
    if name.endswith("running_var"):
        return "u", 1.0, 0.1
    if name.endswith("init_pose"):
        return "u", REST_6D * (shape[-1] // 6), 0.1
    if name.endswith("init_shape"):
        return "u", 0.0, 0.1
    if _EMBED.search(name):
        return "n", 0.0, 0.02
    if _NORM.search(name):
        return ("u", 1.0, 0.1) if name.endswith("weight") else ("u", 0.0, 0.1)
    if re.search(r"ts_attn\.\d+\.bias$", name):
        return "u", 0.5, 0.1
    if name.startswith("backbone.") and name.endswith(".weight"):
        return "n", 0.0, 0.02
    if name.startswith("backbone.") and name.endswith(".bias"):
        return "u", 0.0, 0.02
    if re.search(r"head\.head_(pose|shape)\.weight$", name):
        return "u", 0.0, HEAD_GAIN * _xavier(shape)
    if re.search(r"head\.(fc[12]|head_pose|head_shape)\.(weight|bias)$",
                 name):
        fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
        return "u", 0.0, 1.0 / math.sqrt(fan_in)
    raise KeyError(f"no weight rule for {name} {tuple(shape)}")


def make(template: Dict[str, torch.Tensor], seed: int, device,
         round_to: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A state dict for `template`'s floating-point entries (names and
    shapes only are read), f32 on `device`, from `seed`; `round_to`
    rounds every value to that type (kept in f32), as core/weights.py's
    `make` does."""
    shapes = {k: tuple(v.shape) for k, v in template.items()}
    plan = [(k, rule(k, s, shapes)) for k, s in shapes.items()
            if template[k].is_floating_point()]
    n_u = sum(math.prod(shapes[k]) for k, r in plan if r[0] == "u")
    n_n = sum(math.prod(shapes[k]) for k, r in plan if r[0] == "n")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, i_n = {}, 0, 0
    for k, (draw, centre, half) in plan:
        n = math.prod(shapes[k])
        if draw == "u":
            v, iu = uni[iu:iu + n], iu + n
        else:
            v, i_n = nor[i_n:i_n + n], i_n + n
        c = torch.as_tensor(centre, dtype=torch.float32, device=device)
        v = c + half * v.reshape(shapes[k])
        if round_to is not None:
            v = v.to(round_to).float()
        out[k] = v
    return out
