"""HMR 2.0's weights, made by the benchmark on the card from the seed (the
rules of core/weights.py do not name its parameters).

As there: one uniform and one normal draw of a torch.Generator on the
device, cut into the parameters by name (HMR 2.0's state-dict keys), and
both the program and the plain reference are handed the same tensors.

The distributions are the published initialisers: the backbone's as
ViTPose's (vit.py `_init_weights`: trunc-normal 0.02 linears with zero
biases, trunc-normal 0.02 pos_embed, LayerNorms (1, 0), the patch conv at
torch's default), the decoder's as pose_transformer.py leaves them
(torch's default linears, pos_embedding standard normal, LayerNorms
(1, 0)), with departures that keep a check able to see a fault:
  * the backbone's linear biases are drawn around 0 (they start at 0);
  * decpose, decshape and deccam are drawn at xavier gains POSE_GAIN,
    SHAPE_GAIN and CAM_GAIN, not the 0.01 of the recipe's xavier init (at
    0.01 the mesh hardly depends on the image: MotionBERT's head took the
    same departure, core/mb_weights.py). The decoder's token carries a
    part common to every crop ~15 times its part that varies across
    crops, and the readouts carry both: at SHAPE_GAIN 1 the betas move by
    ~0.14 across crops around an offset of ~2; the 6D pose at POSE_GAIN
    0.1 moves by ~0.014 around an offset of ~0.2, since at gain 1 (offset
    ~2) a joint's two 6D columns come near parallel in about one seed in
    ten and Gram-Schmidt turns a bf16 rounding there into a rotation off
    by tens of degrees (sound bf16 runs read up to 1.16 m); the camera at
    CAM_GAIN 0.1, so that its scale c0 stays near init_cam's 0.9 (at gain
    1 its offset reads ~2, and a c0 near 0 sends cam_t's depth
    2 f / (S c0) off by its own rounding);
  * LayerNorm scales and shifts are drawn around their constants;
  * init_body_pose, init_betas and init_cam, which stand for
    smpl_mean_params.npz (a download), are drawn around the rest pose (6D,
    HMR 2.0's [a1 | a2] layout), 0, and the camera (0.9, 0, 0).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch

POSE_GAIN = 0.1
SHAPE_GAIN = 1.0
CAM_GAIN = 0.1
REST_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)
MEAN_CAM = (0.9, 0.0, 0.0)

_NORM = re.compile(r"(norm[12]?|last_norm)\.(weight|bias)$")
_DEC = "smpl_head.transformer."
_READOUT = re.compile(r"^smpl_head\.dec(pose|shape|cam)\.(weight|bias)$")


def _xavier(shape) -> float:
    fan_out, fan_in = shape
    return math.sqrt(6.0 / (fan_in + fan_out))


def rule(name: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple]
         ) -> Tuple[str, object, float]:
    """-> (draw, centre, half-width): uniform draws give centre +
    half-width * U(-1, 1), normal draws centre + half-width * N(0, 1); a
    centre is a number or a tuple over the last dimension."""
    if name == "smpl_head.init_body_pose":
        return "u", REST_6D * (shape[-1] // 6), 0.1
    if name == "smpl_head.init_betas":
        return "u", 0.0, 0.1
    if name == "smpl_head.init_cam":
        return "u", MEAN_CAM, 0.1
    if name == "backbone.pos_embed":
        return "n", 0.0, 0.02
    if name == _DEC + "pos_embedding":
        return "n", 0.0, 1.0
    if _NORM.search(name):
        return ("u", 1.0, 0.1) if name.endswith("weight") else ("u", 0.0, 0.1)
    fan_in = math.prod(shapes[name.rsplit(".", 1)[0] + ".weight"][1:])
    if name.startswith("backbone.patch_embed."):
        return "u", 0.0, 1.0 / math.sqrt(fan_in)
    if name.startswith("backbone.") and name.endswith(".weight"):
        return "n", 0.0, 0.02
    if name.startswith("backbone.") and name.endswith(".bias"):
        return "u", 0.0, 0.02
    m = _READOUT.match(name)
    if m and m.group(2) == "weight":
        gain = {"pose": POSE_GAIN, "shape": SHAPE_GAIN,
                "cam": CAM_GAIN}[m.group(1)]
        return "u", 0.0, gain * _xavier(shape)
    if m or name.startswith(_DEC):
        return "u", 0.0, 1.0 / math.sqrt(fan_in)
    raise KeyError(f"no weight rule for {name} {tuple(shape)}")


def make(template: Dict[str, torch.Tensor], seed: int, device,
         round_to: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A state dict for `template`'s floating-point entries (names and
    shapes only are read), f32 on `device`, from `seed`; `round_to`
    rounds every value to that type (kept in f32), as core/mb_weights.py's
    `make` does, by this file's rules."""
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
