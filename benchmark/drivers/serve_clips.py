"""Closed-loop clip serving: one `serving.make_serving_fn` call in flight,
the model MotionBERT's mesh model.

Set-up: the port's seeded assets, the model (the port's `MeshRegressor`
at the configuration's widths, its weights made by the benchmark on the
card, rounded to the served type: core/mb_weights.py), the serving
function, a seeded pool of `pool_batches` batches of clips on the card,
and `warmup_calls` calls (the first builds or loads K3). A batch is
`batch` clips of the configuration's `clip_len` frames of its 17 joints,
(x, y, confidence): coordinates uniform in [-1, 1], as MotionBERT's crops
normalise them, confidences in [0, 1]. The window: calls back to back on
the pool's batches in turn, each timed from its dispatch to a
`synchronize`; the outputs stay on the card. serve_poses_per_s counts
frames. The outputs of `sample_calls` calls, drawn from the seed among the
window's first `sample_range`, are kept and judged after the window, every
frame, against the plain float32 reference (reference/motionbert.py) on
the same weights and clips.

With --trace 1, after the window: `trace_calls` calls under the device
trace; the per-layer readers get the trace, the runtime calls and device
operations matched by correlation id (core/launches.py), and K3's launches
a call from the program's counter.

Traffic keys: batch, pool_batches, warmup_calls, sample_calls,
sample_range, trace_calls, ref_block (clips), limits.
"""
from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import yaml

from benchmark.core import check, mb_weights, spec, weights
from benchmark.core import launches as launch_info
from benchmark.core.context import Ctx, Result
from benchmark.core.trace import breakdown, busy_s, read_trace, traced
from benchmark.reference import lowp
from benchmark.reference import model as gref
from benchmark.reference import motionbert as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the frozen recipe's keys, each the configuration file's key of that name
RECIPE_KEYS = ("maxlen", "dim_feat", "mlp_ratio", "depth", "dim_rep",
               "num_heads", "att_fuse", "hidden_dim", "clip_len",
               "num_joints")


def model_spec(cfg: dict):
    """The port's MotionBertSpec at the configuration's settings, once the
    frozen recipe agrees with them."""
    from gator_tpu_torch.models import MotionBertSpec
    with open(spec.config_file(cfg["recipe"])) as f:
        recipe = yaml.safe_load(f)
    if any(recipe[k] != cfg[k] for k in RECIPE_KEYS):
        raise ValueError(f"{cfg['recipe']} disagrees with {cfg['name']}")
    return MotionBertSpec(
        dim_in=cfg["dim_in"], dim_feat=cfg["dim_feat"],
        dim_rep=cfg["dim_rep"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], mlp_ratio=float(cfg["mlp_ratio"]),
        maxlen=cfg["maxlen"], num_joints=cfg["num_joints"],
        hidden_dim=cfg["hidden_dim"], eps=cfg["layer_norm_eps"])


def build_model(cfg: dict, device, seed: int, round_to):
    """-> (assets, the port's MeshRegressor with the benchmark's weights,
    the weights)."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import MeshRegressor

    mspec = model_spec(cfg)
    assets = build_assets(cfg["input_joint_set"], data_dirs=[])
    if (assets.smpl.vertex_num, assets.j_regressor_h36m.shape[0]) != (
            cfg["smpl_vertices"], cfg["num_joints"]):
        raise ValueError(f"{cfg['name']}: the bundle's body model does not "
                         f"have the configuration's sizes")
    with torch.device(device):
        model = MeshRegressor(mspec, assets.smpl, assets.j_regressor_h36m)
    model.eval()
    w = mb_weights.make(model.state_dict(), seed, device, round_to)
    weights.load_into(model, w)
    return assets, model, w


def make_program(model, dtype):
    """The system under test: the port's serving function."""
    from gator_tpu_torch.serving import make_serving_fn
    return make_serving_fn(model, dtype)


def make_pool(seed: int, n: int, b: int, t: int, j: int, device
              ) -> torch.Tensor:
    """[n, B, T, J, 3] clips: x, y uniform in [-1, 1], confidence in
    [0, 1]."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ 0xC11B) % (1 << 63))
    x = torch.rand(n, b, t, j, 3, generator=gen, device=device)
    return torch.cat([x[..., :2] * 2.0 - 1.0, x[..., 2:]], -1)


def sample_calls(seed: int, k: int, upto: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % (1 << 63), 21])
    return sorted(int(i) for i in rng.choice(upto, size=k, replace=False))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def compare(outs: List[Tuple], inputs: List[torch.Tensor], w, tables,
            cfg, block: int, prec=gref.F32) -> Dict[str, float]:
    """The numbers compared: the served meshes and H36M joints against the
    reference's (computed with `prec`, `block` clips at a time), over
    every frame of the kept calls. Mesh and joint gaps are scaled by the
    reference's RMS distance from what the head gives at init_pose and
    init_shape, the part of the answer the clips decide."""
    ref.no_tf32()
    vr, kr, vp, kp = [], [], [], []
    with torch.no_grad():
        init_v, init_k = ref.init_mesh(w, tables)
        for (verts, kp3d), x in zip(outs, inputs):
            for i in range(0, x.shape[0], block):
                v_r, k_r = ref.forward(w, tables, cfg, x[i:i + block],
                                       prec=prec)
                vr.append(v_r)
                kr.append(k_r)
                vp.append(verts[i:i + block].float())
                kp.append(kp3d[i:i + block].float())
    vr, kr, vp, kp = (torch.cat(z) for z in (vr, kr, vp, kp))
    deform = check.rms(vr - init_v)
    return {
        "mesh_rel_rms": check.rel_rms(vp, vr, deform),
        "mesh_clip_rel_rms_max": check.row_rel_rms_max(vp, vr, deform),
        "mesh_max_abs_m": check.max_abs(vp, vr),
        "kp3d_rel_rms": check.rel_rms(kp, kr, check.rms(kr - init_k)),
    }


def traced_calls(ctx: Ctx, serve, pool, res: Result, n_calls: int) -> None:
    """`n_calls` calls under the device trace -> the per-layer readers'
    inputs in res.layer, busy and window, the breakdown."""
    from gator_tpu_torch.nn import fused_attention
    dev = torch.device(ctx.device)
    path = osp.join(ctx.scratch, f"trace-{ctx.cell}.json")
    launches0 = fused_attention.launches
    ctx.spans.tracing = True
    with traced(path):
        with ctx.spans.span("window"):
            for i in range(n_calls):
                with ctx.spans.span("serve_call"):
                    serve(pool[i % len(pool)])
                    with ctx.spans.span("sync"):
                        _sync(dev)
    ctx.spans.tracing = False
    try:
        tr = read_trace(path, ctx.spans.marks, remove=False)
        info = launch_info.read(path, tr.window)
    finally:
        os.remove(path)
    k3 = (fused_attention.launches - launches0) / n_calls
    res.layer.update(trace=tr, launches=info, traced_calls=n_calls,
                     k3_launches_per_call=k3)
    res.busy_s, res.window_s = busy_s(tr), tr.window_s
    res.breakdown = dict(breakdown(tr), launches_per_call={
        "fused_attention": k3})


def run(ctx: Ctx) -> Result:
    cfg, mix, dev = ctx.cfg, ctx.mix, torch.device(ctx.device)
    dtype = DTYPES[cfg["precision"]]
    b, t, j = mix["batch"], cfg["clip_len"], cfg["num_joints"]
    assets, model, w = build_model(cfg, dev, ctx.seed, dtype)
    serve = make_program(model, dtype)
    pool = make_pool(ctx.seed, mix["pool_batches"], b, t, j, dev)
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
    res.e2e["serve_poses_per_s"] = n * b * t / elapsed
    res.e2e["serve_call_p95_ms"] = float(np.percentile(times, 95)) * 1e3
    res.layer.update(calls_per_s=n / elapsed, batch=b, clip_len=t, cfg=cfg,
                     frames_per_s=n * b * t / elapsed)

    if ctx.trace:
        traced_calls(ctx, serve, pool, res, mix["trace_calls"])

    res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    del serve, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tables = ref.tables_of(assets, dev)
    # no kept call leaves every number missing, and the run not correct
    res.values = compare(kept, kept_in, w, tables, cfg,
                         mix["ref_block"]) if kept else {}
    res.limits = dict(mix["limits"])
    return res


def control(cfg: dict, mix: dict, seed: int, device, kind: str = "fp8"
            ) -> Tuple[Dict[str, float], dict]:
    """The control: the reference computed with fp8 operands in the
    program's place (the backbone's and head's products; SMPL stays f32,
    as the program's does), on the clips the cell's run with `seed` would
    judge, held to the same numbers."""
    if kind != "fp8":
        raise ValueError(f"unknown control {kind!r}")
    dev = torch.device(device)
    assets, model, w = build_model(cfg, dev, seed,
                                   DTYPES[cfg["precision"]])
    del model
    tables = ref.tables_of(assets, dev)
    pool = make_pool(seed, mix["pool_batches"], mix["batch"],
                     cfg["clip_len"], cfg["num_joints"], dev)
    idx = sample_calls(seed, mix["sample_calls"], mix["sample_range"])
    inputs = [pool[i % len(pool)] for i in idx]
    blk = mix["ref_block"]
    outs = []
    with torch.no_grad():
        for x in inputs:
            parts = [ref.forward(w, tables, cfg, x[i:i + blk],
                                 prec=lowp.FP8)
                     for i in range(0, x.shape[0], blk)]
            outs.append((torch.cat([p[0] for p in parts]),
                         torch.cat([p[1] for p in parts])))
    return compare(outs, inputs, w, tables, cfg, blk), {}
