"""LBF-layer ablations on one CUDA device.

    python -m gator_tpu_torch.tools.exp_mdr_ablate [mode ...]

The counterpart of tools/exp_mdr_ablate.py. Runs the three LBF layers of
the full-width synthetic human36 model (seeded random weights) on T1
(`nn.run_layers`) at [2048, 431, 64] bf16 with 17 seeded random joint
tokens, once per mode asked for (default: full, bf16smax, fold1dot; the
modes are `nn.MODES`), and prints `<mode>-g8  <ms>` per mode: the median
of 5 runs of 3 calls by CUDA events. An unknown mode raises. `main`
returns the numbers. Fails without a CUDA device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..nn import MODES, extract_layer_params, run_layers
from .timing import card_name, time_ms

BATCH = 2048
GROUP = 8
DEFAULT_MODES = ("full", "bf16smax", "fold1dot")


def main(argv=None):
    modes = list(argv) if argv else list(DEFAULT_MODES)
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"exp_mdr_ablate: unknown modes {unknown}; modes "
                         f"are {', '.join(MODES)}")
    if not torch.cuda.is_available():
        raise SystemExit("exp_mdr_ablate: no CUDA device")
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator

    card = card_name()
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    spec = GatorSpec.from_assets(assets, embed_dim=128, depth=6, alpha=False)
    mdr = build_gator(spec, seed=0, device="cuda").pose2mesh
    bf16 = torch.bfloat16
    layers = [extract_layer_params(mdr, i, bf16, "cuda") for i in range(3)]
    rng = np.random.default_rng(0)
    verts = torch.from_numpy(rng.normal(size=(
        BATCH, spec.mdr.coarse_num, 64)).astype(np.float32)).to("cuda", bf16)
    joints = torch.from_numpy(rng.normal(size=(BATCH, 17, 64)).astype(
        np.float32)).to("cuda", bf16)
    print(f"3 LBF layers at [{BATCH}, {spec.mdr.coarse_num}, 64] bf16, 17 "
          f"joints, on {card}")
    ms = {}
    with torch.no_grad():
        for mode in modes:
            name = f"{mode}-g{GROUP}"
            ms[name] = time_ms(lambda mode=mode: run_layers(
                verts, joints, layers, spec.mdr.num_heads, GROUP, mode))
            print(f"{name:14s} {ms[name]:8.3f} ms", flush=True)
    return {"card": card, "batch": BATCH, "dtype": "bfloat16", "ms": ms}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:]) else 1)
