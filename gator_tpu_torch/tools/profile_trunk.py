"""K1 (the GAT trunk) and the serving call on one CUDA device, by batch.

    python -m gator_tpu_torch.tools.profile_trunk [--batches 1 64 256 2048]

Builds the full-width synthetic human36 model (6890/431 vertices, embed
128, depth 6, seeded random weights) and times, in bf16 at each batch: K1
(`nn.gat_trunk`) and its plain version (`gat_trunk_ref`) on seeded
[B, 17, 128] tokens, and the whole serving call (`make_serving_fn`, on the
kernels and on the plain versions) on seeded poses; CUDA events, median of
5 runs of 3 calls. At the largest batch it also reads K1's device time per
launch from torch.profiler. It uses only the package's public entry
points, so a copy of it runs unchanged in an older tree: to compare two
trees, run it from each in one call. Prints the card's name and power
limit; `main` returns the numbers. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .timing import card_name, time_ms

DTYPE = torch.bfloat16


def k1_device_ms(fn, calls: int = 3) -> float:
    """Device ms per call of K1's kernel (`gat_trunk_kernel`) in `fn`, from
    torch.profiler."""
    from .profile_train import _device_us, _is_kernel
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if _is_kernel(e) and "gat_trunk_kernel" in e.key) / 1e3 / calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1, 64, 256, 2048])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trunk: no CUDA device")
    from ..assets import build_assets
    from ..models import GatorSpec, build_gator
    from ..nn import fold_trunk_weights, gat_trunk, gat_trunk_ref
    from ..serving import make_serving_fn

    card = card_name()
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    model = build_gator(GatorSpec.from_assets(assets, embed_dim=128, depth=6,
                                              alpha=False), seed=0,
                        device="cuda")
    gat = model.pose_lifter
    j = gat.spec.num_joint
    weights = fold_trunk_weights(gat.blocks, DTYPE, "cuda")
    bias = gat.get_hop_path_encoding().float()
    masks = gat.blocks[0].x_feat.masks
    serve = make_serving_fn(model, DTYPE)
    serve_plain = make_serving_fn(model, DTYPE, use_kernels=False)
    rng = np.random.default_rng(0)
    out = {"card": card, "dtype": "bfloat16", "ms": {}}
    print(f"K1 and the serving call, bf16, human36, on {card}")
    with torch.no_grad():
        for b in args.batches:
            x = torch.from_numpy(rng.normal(size=(b, j, 128)).astype(
                np.float32)).to("cuda", DTYPE)
            pose = torch.from_numpy(rng.normal(size=(b, j, 2)).astype(
                np.float32)).cuda()
            k1 = lambda: gat_trunk(x, bias, masks, weights, 8)  # noqa: E731
            ms = {"k1": time_ms(k1),
                  "k1_plain": time_ms(lambda: gat_trunk_ref(
                      x, bias, masks, weights, 8)),
                  "serve": time_ms(lambda: serve(pose)),
                  "serve_plain": time_ms(lambda: serve_plain(pose))}
            if b == max(args.batches):
                ms["k1_device"] = k1_device_ms(k1)
            out["ms"][b] = ms
            print(f"  B={b:5d}: K1 {ms['k1']:.4f} ms (plain "
                  f"{ms['k1_plain']:.4f})"
                  + (f", device {ms['k1_device']:.4f} ms per launch"
                     if "k1_device" in ms else "")
                  + f"; serving call {ms['serve']:.4f} ms (plain "
                  f"{ms['serve_plain']:.4f})", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
