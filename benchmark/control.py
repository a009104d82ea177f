#!/usr/bin/env python3
"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--control fp8] [--seconds 2]

Without --control: the cell's own run (its driver, a short window of
--seconds at the cell's load) on each seed, in one process, printing the
numbers compared. With --control fp8: the control, the plain reference
computed with fp8 operands in the program's place, on the inputs each
seed's run would judge, at the cell's size. Training cells also take
faults planted in the reference put in the program's place, which the
numbers must see: --control half (each step's mean over half the
batch), --control altered (one row of each assembled batch and of the
packed table altered). One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control",
                   choices=("fp8", "half", "altered"),
                   default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    import torch
    from benchmark.core import spec
    from benchmark.core.context import Ctx

    parts = spec.resolve(a.workload)
    drv, cfg, mix = parts["driver"], parts["config"], parts["traffic"]
    for seed in a.seeds:
        if a.control:
            values, info = drv.control(cfg, mix, seed, a.device, a.control)
        else:
            ctx = Ctx(cell=a.workload, seed=seed, seconds=a.seconds,
                      trace=False, cfg=cfg, mix=mix, device=a.device,
                      chips=int(parts["cell"]["chips"]))
            values, info = drv.run(ctx).values, {}
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": a.control, "values": values,
                          "look": info}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
