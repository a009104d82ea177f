"""GATOR's weights, made by the benchmark on the card from the seed.

One uniform and one normal draw of a torch.Generator on the device, cut
into the parameters by name (the reference's state-dict keys). Both the
program and the plain reference are handed the same tensors.

The distributions are the reference's initialisation (torch's defaults,
the MGCN's xavier), with three departures that keep a check able to see
a fault:
  * GraphLinear takes a Linear's bound 1/sqrt(in), not 1/(in*out): with
    the latter the pose enters the tokens at 1e-4 of the position
    embeddings, and a row mix-up would leave the output all but unchanged;
  * the lifter's output linear is scaled so that the lifted pose is in
    millimetres, as a trained lifter's is (its 3D coordinates reach the
    MDR's vertex tokens divided by 1000);
  * every parameter that starts as a constant (norm scales and shifts,
    the hop/path weights, the MGCN adjacency residual, BatchNorm running
    statistics) is drawn around that constant, so that a path that
    ignored it would read differently.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch

LIFTER_BOUND = 10.0            # pose3d about 150-300 mm from gelu(LN) feats

_EMBED = re.compile(r"(_embed|spatial_pos_encoder)\.weight$")
_NORM = re.compile(r"(norm\d*|norm_\d+|GLinear\.1|bias_norm)\.(weight|bias)$"
                   r"|\.(a_2|b_2)$")


def rule(name: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple]
         ) -> Tuple[str, float, float]:
    """-> (draw, centre, half-width): uniform draws give centre +
    half-width * U(-1, 1), normal draws centre + half-width * N(0, 1)."""
    if name.endswith("running_mean"):
        return "u", 0.0, 0.1
    if name.endswith("running_var"):
        return "u", 1.0, 0.1
    if _EMBED.search(name):
        return "n", 0.0, 1.0
    if _NORM.search(name):
        return ("u", 1.0, 0.1) if name.endswith(("weight", "a_2")) \
            else ("u", 0.0, 0.1)
    if name.endswith("get_hop_path_encoding.W"):
        return "u", 1.0, 0.1
    if name.endswith("gcn.W"):
        _, fin, fout = shape
        return "u", 0.0, 1.414 * math.sqrt(6.0 / (fin * fout + 2 * fout))
    if name.endswith("gcn.M"):
        j, fout = shape
        return "u", 0.0, 1.414 * math.sqrt(6.0 / (fout + j))
    if name.endswith("gcn.adj2"):
        return "u", 0.0, 0.05
    if name.endswith("gcn.bias"):
        return "u", 0.0, 1.0 / math.sqrt(shape[0])
    if re.search(r"GLinear\.\d\.(W|b)$", name):
        w = shapes[name[:-1] + "W"]
        return "u", 0.0, 1.0 / math.sqrt(w[1])
    if name.endswith("lifter.weight") or name.endswith("lifter.bias"):
        return "u", 0.0, LIFTER_BOUND
    if name.endswith(".weight") and len(shape) == 3:      # Conv1d, k=3
        return "u", 0.0, 1.0 / math.sqrt(shape[1] * 3)
    if name.endswith(".weight") and len(shape) == 2:      # Linear
        return "u", 0.0, 1.0 / math.sqrt(shape[1])
    if name.endswith(".bias"):
        w = shapes.get(name[:-4] + "weight")
        if w is not None:
            fan = w[1] * (3 if len(w) == 3 else 1)
            return "u", 0.0, 1.0 / math.sqrt(fan)
    raise KeyError(f"no weight rule for {name} {tuple(shape)}")


def make(template: Dict[str, torch.Tensor], seed: int, device,
         round_to: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A state dict for `template`'s floating-point entries (names and
    shapes only are read), f32 on `device`, from `seed`. `round_to`
    rounds every value to that type (kept in f32): the weights as a
    program serving in that type holds them, so that the reference starts
    from the same numbers."""
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
        v = (centre + half * v).reshape(shapes[k])
        if _EMBED.search(k):
            v[0] = 0.0                       # padding_idx row
        if round_to is not None:
            v = v.to(round_to).float()
        out[k] = v
    return out


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy `sd` into the model's parameters and buffers (entries it
    lacks, such as BatchNorm's step counter, keep the model's values)."""
    full = model.state_dict()
    missing = set(sd) - set(full)
    if missing:
        raise KeyError(f"weights the model has no place for: {missing}")
    full.update(sd)
    model.load_state_dict(full, strict=True)
