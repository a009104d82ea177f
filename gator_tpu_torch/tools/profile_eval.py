"""Where the time of the evaluation loop goes, on one CUDA device.

    python -m gator_tpu_torch.tools.profile_eval [--n 2048]
        [--out build/profile_eval.json]

Builds the eval session of configs/gator_synthetic_e2e.yml (full-width
synthetic human36 model with seeded random weights, `--n` synthetic samples,
TEST.batch_size 512, f32), warms up with one pass, times `run_eval` over
the whole set on the host clock, then profiles one more pass and, apart,
one eval step on a fixed batch and one pass of the batch pipeline alone
(GT synthesis and batch assembly) with torch.profiler (CPU and CUDA
activities). Prints poses/s, the device time per kernel group (K3 and the
largest plain-torch kernels), and the device's busy and idle shares; writes
the same as JSON to --out. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

from .profile_train import _device_us, _is_kernel
from .timing import card_name

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _profile(fn):
    """-> (host ms of fn() synchronised, {kernel name: device ms})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    for evt in prof.key_averages():
        if _is_kernel(evt):
            kernels[evt.key[:90]] += _device_us(evt) / 1e3
    return ms, kernels


def _summary(label, ms, kernels, top=10):
    busy = sum(kernels.values())
    k3 = sum(v for k, v in kernels.items() if "attention_kernel" in k)
    out = {"host_ms": ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / ms),
           "k3_ms": k3, "top": kernels.most_common(top)}
    print(f"{label}: {ms:.3f} ms on the host clock; device busy {busy:.3f} "
          f"ms (idle {100 * out['device_idle_share']:.1f} %); K3 "
          f"{k3:.3f} ms")
    for name, v in out["top"]:
        print(f"    {v:8.3f} ms  {name}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--out", default="build/profile_eval.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    from gator_tpu_torch.cli.common import Session
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.train import run_eval

    card = card_name()
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_e2e.yml"))
    sess = Session(cfg, synthetic=True, synthetic_n=args.n)
    model = sess.build_model()
    step = sess.make_eval_step()

    def loop():
        return run_eval(step, model, sess.pipeline)

    loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    batch = next(iter(sess.pipeline))
    step(model, batch)
    result = {
        "card": card, "samples": args.n, "batch": cfg.TEST.batch_size,
        "dtype": "float32", "joint_set": "human36", "loop_ms": loop_ms,
        "poses_per_s": args.n / loop_ms * 1e3,
    }
    print(f"eval loop, {args.n} samples, B={cfg.TEST.batch_size}, f32, "
          f"human36, on {card}: {loop_ms:.1f} ms = "
          f"{result['poses_per_s']:,.0f} poses/s (host clock)")
    result["loop"] = _summary("profiled loop", *_profile(loop))
    result["step"] = _summary("one eval step",
                              *_profile(lambda: step(model, batch)))
    result["pipeline"] = _summary(
        "the pipeline alone (GT synthesis, assembly)",
        *_profile(lambda: [None for _ in sess.pipeline]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
