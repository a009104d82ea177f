#!/usr/bin/env python3
"""The benchmark of gator_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout and prints one
JSON line as the last line of its standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks` (each number compared beside its limit,
also the last lines of standard error).

It exits non-zero and prints no result when there is no card or fewer
cards than the cell asks for, when the program or a part of the cell
cannot be found, or when a module of the JAX package or of JAX is loaded
once the window has closed (benchmark/core/guard.py).

Build caches stay inside the checkout: the port builds its kernels into
build/kernels; traces go to build/benchmark and are deleted once read.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def result_line(res, ctx, bench, cell, setup_s, device) -> dict:
    from benchmark.core import check, spec
    correct, checks = check.judge(res.values, res.limits)
    metrics = {}
    if not ctx.trace:
        values = dict(res.e2e, setup_s=setup_s)
        for m in spec.end_to_end(bench, cell["name"]):
            if m["name"] not in values:
                raise KeyError(f"cell {cell['name']} measured no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(bench, cell["name"]):
            v = spec.metric_reader(m["name"]).read(res.layer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=int(res.memory_peak_bytes))
    if ctx.trace:
        dev.update(busy_s=res.busy_s, window_s=res.window_s)
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": dev}
    if ctx.trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    age0 = process_age_s()
    try:
        from benchmark.core import guard, spec
        from benchmark.core.context import Ctx
        parts = spec.resolve(args.workload)
    except (OSError, KeyError, ValueError, ImportError) as e:
        return fail(f"cannot resolve cell {args.workload!r}: {e!r}", 2)
    cell = parts["cell"]
    chips = int(cell["chips"])
    cache = osp.join(spec.SCRATCH, "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, osp.join(cache, sub))
    os.makedirs(spec.SCRATCH, exist_ok=True)

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device", 2)
    if torch.cuda.device_count() < chips:
        return fail(f"cell {cell['name']} needs {chips} cards; "
                    f"{torch.cuda.device_count()} found", 2)
    try:
        import gator_tpu_torch  # noqa: F401  (the program must be here)
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e!r}", 2)

    ctx = Ctx(cell=cell["name"], seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), cfg=parts["config"],
              mix=parts["traffic"], device="cuda", chips=chips,
              scratch=spec.SCRATCH)
    res = parts["driver"].run(ctx)
    if ctx.window_start is None:
        return fail("the driver opened no window", 1)
    setup_s = age0 + (ctx.window_start - T0)

    banned = guard.loaded_banned()
    if banned:
        return fail(f"modules of JAX or of the JAX package were loaded: "
                    f"{banned}", 3)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "power_limit_w": power_limit_w()}
    line = result_line(res, ctx, parts["bench"], cell, setup_s, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
