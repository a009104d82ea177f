"""Closed-loop batch serving: one `serving.make_serving_fn` call in flight.

Set-up: the port's seeded assets, the model (the port's `GATOR`, its
weights made by the benchmark on the card, rounded to the served type),
the serving function, a seeded pool of `pool_batches` batches of poses on
the card, and `warmup_calls` calls (the first builds or loads the
kernels). The window: calls back to back on the pool's batches in turn,
each timed from its dispatch to a `synchronize`; the outputs stay on the
card. The outputs of `sample_calls` calls, drawn from the seed among the
window's first `sample_range`, are kept and judged after the window
against the plain float32 reference on the same weights and inputs.

Traffic keys: batch, pool_batches, warmup_calls, sample_calls,
sample_range, trace_calls, ref_block, limits.
"""
from __future__ import annotations

import os.path as osp
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.core import check, spec, weights
from benchmark.core.context import Ctx, Result
from benchmark.core.trace import breakdown, busy_s, read_trace, traced
from benchmark.reference import model as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, device, seed: int, round_to):
    """-> (assets, the port's GATOR with the benchmark's weights, the
    weights)."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.models import GATOR, GatorSpec

    g = cfg["gat"]
    rc = load_config(spec.config_file(cfg["recipe"]))
    stated = (cfg["input_joint_set"], cfg["mdr"]["alpha"], g["embed_dim"],
              g["depth"], g["num_heads"])
    if (rc.DATASET.input_joint_set, rc.MODEL.alpha, rc.MODEL.embed_dim,
            rc.MODEL.depth, rc.MODEL.num_heads) != stated:
        raise ValueError(f"{cfg['recipe']} disagrees with {cfg['name']}")
    assets = build_assets(cfg["input_joint_set"], data_dirs=[])
    if assets.joint_num != cfg["num_joint"]:
        raise ValueError(f"{cfg['name']}: {assets.joint_num} joints, the "
                         f"configuration states {cfg['num_joint']}")
    model = GATOR(GatorSpec.from_assets(
        assets, embed_dim=g["embed_dim"], depth=g["depth"],
        alpha=cfg["mdr"]["alpha"])).to(device).eval()
    w = weights.make(model.state_dict(), seed, device, round_to)
    weights.load_into(model, w)
    return assets, model, w


def make_program(model, dtype) -> Callable:
    """The system under test: the port's serving function."""
    from gator_tpu_torch.serving import make_serving_fn
    return make_serving_fn(model, dtype)


def make_pool(seed: int, n: int, b: int, j: int, device) -> torch.Tensor:
    """[n, B, J, 2] standardised 2D poses (each sample's joints centred
    and scaled per coordinate, as the training input is)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ 0x5EED) % (1 << 63))
    x = torch.randn(n * b, j, 2, generator=gen, device=device)
    x = x - x.mean(1, keepdim=True)
    x = x / torch.sqrt((x * x).mean(1, keepdim=True))
    return x.reshape(n, b, j, 2)


def sample_calls(seed: int, k: int, upto: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % (1 << 63), 17])
    return sorted(int(i) for i in rng.choice(upto, size=k, replace=False))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def compare(outs: List[Tuple], inputs: List[torch.Tensor], w, tables,
            cfg, block: int, prec=ref.F32) -> Dict[str, float]:
    """The numbers compared: the served meshes and lifted poses against
    the reference's (computed with `prec`, blockwise), over every row of
    the kept calls."""
    ref.no_tf32()
    mesh_r, pose_r, mesh_p, pose_p = [], [], [], []
    for (mesh, pose3d), x in zip(outs, inputs):
        with torch.no_grad():
            for i in range(0, x.shape[0], block):
                m_r, p_r, _ = ref.forward(w, tables, cfg, x[i:i + block],
                                          prec=prec)
                mesh_r.append(m_r)
                pose_r.append(p_r)
                mesh_p.append(mesh[i:i + block].float())
                pose_p.append(pose3d[i:i + block].float())
    mesh_r, pose_r = torch.cat(mesh_r), torch.cat(pose_r)
    mesh_p, pose_p = torch.cat(mesh_p), torch.cat(pose_p)
    deform = check.rms(mesh_r - tables["init_verts_full"])
    return {
        "mesh_rel_rms": check.rel_rms(mesh_p, mesh_r, deform),
        "mesh_row_rel_rms_max": check.row_rel_rms_max(mesh_p, mesh_r,
                                                      deform),
        "mesh_max_abs_m": check.max_abs(mesh_p, mesh_r),
        "pose3d_rel_rms": check.rel_rms(pose_p, pose_r, check.rms(pose_r)),
    }


def run(ctx: Ctx) -> Result:
    cfg, mix, dev = ctx.cfg, ctx.mix, torch.device(ctx.device)
    dtype = DTYPES[cfg["precision"]]
    b, j = mix["batch"], cfg["num_joint"]
    assets, model, w = build_model(cfg, dev, ctx.seed, dtype)
    serve = make_program(model, dtype)
    pool = make_pool(ctx.seed, mix["pool_batches"], b, j, dev)
    for i in range(mix["warmup_calls"]):
        serve(pool[i % len(pool)])
    _sync(dev)

    keep_at = set(sample_calls(ctx.seed, mix["sample_calls"],
                               mix["sample_range"]))
    kept, kept_in, times = [], [], []
    n = 0
    t_open = ctx.open_window()
    while True:
        t0 = time.perf_counter()
        if t0 - t_open >= ctx.seconds:
            break
        x = pool[n % len(pool)]
        out = serve(x)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        if n in keep_at:
            kept.append(out)
            kept_in.append(x)
        n += 1
    elapsed = time.perf_counter() - t_open
    out = None
    res = Result(attempted=n, failed=0)
    res.e2e["serve_poses_per_s"] = n * b / elapsed
    res.e2e["serve_call_p95_ms"] = float(np.percentile(times, 95)) * 1e3
    res.layer.update(calls_per_s=n / elapsed, batch=b, cfg=cfg,
                     poses_per_s=n * b / elapsed)

    if ctx.trace:
        path = osp.join(ctx.scratch, f"trace-{ctx.cell}.json")
        ctx.spans.tracing = True
        with traced(path):
            with ctx.spans.span("window"):
                for i in range(mix["trace_calls"]):
                    with ctx.spans.span("serve_call"):
                        serve(pool[i % len(pool)])
                        with ctx.spans.span("sync"):
                            _sync(dev)
        ctx.spans.tracing = False
        tr = read_trace(path, ctx.spans.marks)
        res.layer.update(trace=tr, traced_calls=mix["trace_calls"])
        res.busy_s, res.window_s = busy_s(tr), tr.window_s
        res.breakdown = breakdown(tr)

    res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    del serve, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tables = ref.tables_on(ref.arrays_of(assets, cfg["input_joint_set"]),
                           dev)
    # no kept call leaves every number missing, and the run not correct
    res.values = compare(kept, kept_in, w, tables, cfg,
                         mix["ref_block"]) if kept else {}
    res.limits = dict(mix["limits"])
    return res


def control(cfg: dict, mix: dict, seed: int, device, kind: str = "fp8"
            ) -> Dict[str, float]:
    """The control: the reference computed with fp8 operands in the
    program's place, on the inputs the cell's run with `seed` would
    judge, held to the same numbers."""
    from benchmark.reference import lowp
    if kind != "fp8":
        raise ValueError(f"unknown control {kind!r}")
    prec = lowp.FP8
    dev = torch.device(device)
    assets, model, w = build_model(cfg, dev, seed, DTYPES[cfg["precision"]])
    tables = ref.tables_on(ref.arrays_of(assets, cfg["input_joint_set"]),
                           dev)
    del model
    pool = make_pool(seed, mix["pool_batches"], mix["batch"],
                     cfg["num_joint"], dev)
    idx = sample_calls(seed, mix["sample_calls"], mix["sample_range"])
    inputs = [pool[i % len(pool)] for i in idx]
    outs = []
    with torch.no_grad():
        for x in inputs:
            parts = [ref.forward(w, tables, cfg, x[i:i + mix["ref_block"]],
                                 prec=prec)[:2]
                     for i in range(0, x.shape[0], mix["ref_block"])]
            outs.append((torch.cat([p[0] for p in parts]),
                         torch.cat([p[1] for p in parts])))
    return compare(outs, inputs, w, tables, cfg, mix["ref_block"]), {}
