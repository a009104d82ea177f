"""Closed-loop crop serving: one `serving.make_serving_fn` call in flight,
the model HMR 2.0.

Set-up: the port's seeded assets (the body model), the model (the port's
`HMR2` at the configuration's widths, its weights made by the benchmark on
the card, rounded to the served type: core/hmr2_weights.py), the serving
function, a seeded pool of `pool_batches` batches of crops on the card,
and `warmup_calls` calls (the first builds or loads K3). A batch is
`batch` person crops of the configuration's image_size square, pixels
uniform in [0, 1] normalised by the recipe's ImageNet mean and std, held
in f32. The window: calls back to back on the pool's batches in turn,
each timed from its dispatch to a `synchronize`; the outputs stay on the
card. serve_poses_per_s counts crops. The outputs of `sample_calls`
calls, drawn from the seed among the window's first `sample_range`, are
kept and judged after the window, every crop, against the plain float32
reference (reference/hmr2.py) on the same weights and crops.

With --trace 1, after the window: `trace_calls` calls under the device
trace; the per-layer readers get the trace, the runtime calls and device
operations matched by correlation id (core/launches.py), and K3's launches
a call from the program's counters (in all, on the short-row kernel, by
head width).

Traffic keys: batch, pool_batches, warmup_calls, sample_calls,
sample_range, trace_calls, ref_block (crops), limits.
"""
from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import yaml

from benchmark.core import check, hmr2_weights, spec, weights
from benchmark.core import launches as launch_info
from benchmark.core.context import Ctx, Result
from benchmark.core.trace import breakdown, busy_s, read_trace, traced
from benchmark.reference import hmr2 as ref
from benchmark.reference import model as gref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the frozen recipe's keys (a path in the YAML) and the configuration
# file's key each must equal
RECIPE_KEYS = {
    ("MODEL", "IMAGE_SIZE"): "image_size",
    ("MODEL", "IMAGE_MEAN"): "image_mean",
    ("MODEL", "IMAGE_STD"): "image_std",
    ("MODEL", "BACKBONE", "patch_size"): "patch_size",
    ("MODEL", "BACKBONE", "padding"): "patch_padding",
    ("MODEL", "BACKBONE", "embed_dim"): "embed_dim",
    ("MODEL", "BACKBONE", "depth"): "depth",
    ("MODEL", "BACKBONE", "num_heads"): "num_heads",
    ("MODEL", "BACKBONE", "mlp_ratio"): "mlp_ratio",
    ("MODEL", "BACKBONE", "qkv_bias"): "qkv_bias",
    ("MODEL", "SMPL_HEAD", "IEF_ITERS"): "ief_iters",
    ("MODEL", "SMPL_HEAD", "JOINT_REP"): "joint_rep",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_INPUT"): "transformer_input",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "dim"): "dec_dim",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "depth"): "dec_depth",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "heads"): "dec_heads",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "mlp_dim"): "dec_mlp_dim",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "dim_head"):
        "dec_dim_head",
    ("MODEL", "SMPL_HEAD", "TRANSFORMER_DECODER", "context_dim"):
        "context_dim",
    ("EXTRA", "FOCAL_LENGTH"): "focal_length",
}


def check_recipe(cfg: dict) -> None:
    """Raises unless the frozen recipe agrees with the configuration."""
    with open(spec.config_file(cfg["recipe"])) as f:
        recipe = yaml.safe_load(f)

    def at(path):
        node = recipe
        for k in path:
            node = node[k]
        return node

    bad = [k for path, k in RECIPE_KEYS.items() if at(path) != cfg[k]]
    if at(("MODEL", "BACKBONE", "img_size")) != [cfg["img_h"], cfg["img_w"]]:
        bad.append("img_size")
    if bad:
        raise ValueError(f"{cfg['recipe']} disagrees with {cfg['name']} on "
                         f"{bad}")


def model_spec(cfg: dict):
    """The port's Hmr2Spec at the configuration's settings, once the frozen
    recipe agrees with them. The port runs one IEF iteration of 6D joints
    from a zero token, the recipe's head."""
    from gator_tpu_torch.models import Hmr2Spec
    check_recipe(cfg)
    if (cfg["ief_iters"], cfg["joint_rep"], cfg["transformer_input"],
            cfg["context_dim"], cfg["qkv_bias"]) != (
                1, "6d", "zero", cfg["embed_dim"], True):
        raise ValueError(f"{cfg['name']}: the port runs HMR 2.0's one IEF "
                         f"iteration of 6D joints from a zero token over "
                         f"the backbone's tokens, with a qkv bias")
    return Hmr2Spec(
        image_size=cfg["image_size"], img_h=cfg["img_h"], img_w=cfg["img_w"],
        patch_size=cfg["patch_size"], patch_padding=cfg["patch_padding"],
        embed_dim=cfg["embed_dim"], depth=cfg["depth"],
        num_heads=cfg["num_heads"], mlp_ratio=float(cfg["mlp_ratio"]),
        eps=cfg["layer_norm_eps"], dec_dim=cfg["dec_dim"],
        dec_depth=cfg["dec_depth"], dec_heads=cfg["dec_heads"],
        dec_dim_head=cfg["dec_dim_head"], dec_mlp_dim=cfg["dec_mlp_dim"],
        dec_eps=cfg["dec_layer_norm_eps"],
        focal_length=float(cfg["focal_length"]))


def build_model(cfg: dict, device, seed: int, round_to):
    """-> (assets, the port's HMR2 with the benchmark's weights, the
    weights)."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import HMR2

    mspec = model_spec(cfg)
    assets = build_assets("human36", data_dirs=[])
    if (assets.smpl.vertex_num, len(assets.smpl.kintree_parents)) != (
            cfg["smpl_vertices"], cfg["smpl_joints"]):
        raise ValueError(f"{cfg['name']}: the bundle's body model does not "
                         f"have the configuration's sizes")
    with torch.device(device):
        model = HMR2(mspec, assets.smpl)
    model.eval()
    w = hmr2_weights.make(model.state_dict(), seed, device, round_to)
    weights.load_into(model, w)
    return assets, model, w


def make_program(model, dtype):
    """The system under test: the port's serving function."""
    from gator_tpu_torch.serving import make_serving_fn
    return make_serving_fn(model, dtype)


def make_pool(seed: int, n: int, b: int, cfg: dict, device) -> torch.Tensor:
    """[n, B, 3, S, S] crops: pixels uniform in [0, 1], normalised by the
    recipe's mean and std, f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ 0xC80B) % (1 << 63))
    s = cfg["image_size"]
    x = torch.rand(n, b, 3, s, s, generator=gen, device=device)
    mean = torch.tensor(cfg["image_mean"], device=device)[:, None, None]
    std = torch.tensor(cfg["image_std"], device=device)[:, None, None]
    return (x - mean) / std


def sample_calls(seed: int, k: int, upto: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % (1 << 63), 25])
    return sorted(int(i) for i in rng.choice(upto, size=k, replace=False))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def compare(outs: List[Tuple], inputs: List[torch.Tensor], w, tables,
            cfg, block: int, prec=gref.F32) -> Dict[str, float]:
    """The numbers compared: the served meshes and SMPL joints against the
    reference's (computed with `prec`, `block` crops at a time), over
    every crop of the kept calls. Mesh and joint gaps are scaled by the
    reference's RMS distance from what the head gives at the mean
    parameters (init_body_pose, init_betas), the part of the answer the
    crops decide; rows are crops. The camera translation is not among
    them: its distance from init_cam's is one draw a seed, and scaled by
    it the sound runs' gap spans the fp8 control's (PERF.md)."""
    gref.no_tf32()
    vp, jp, vr, jr = [], [], [], []
    with torch.no_grad():
        init = ref.init_output(w, tables, cfg)
        for (verts, joints, _), x in zip(outs, inputs):
            for i in range(0, x.shape[0], block):
                v_r, j_r, _ = ref.forward(w, tables, cfg, x[i:i + block],
                                          prec=prec)
                vr.append(v_r)
                jr.append(j_r)
                vp.append(verts[i:i + block].float())
                jp.append(joints[i:i + block].float())
    vr, jr, vp, jp = (torch.cat(z) for z in (vr, jr, vp, jp))
    deform = check.rms(vr - init[0])
    return {
        "mesh_rel_rms": check.rel_rms(vp, vr, deform),
        "mesh_row_rel_rms_max": check.row_rel_rms_max(vp, vr, deform),
        "mesh_max_abs_m": check.max_abs(vp, vr),
        "joints_rel_rms": check.rel_rms(jp, jr, check.rms(jr - init[1])),
    }


def traced_calls(ctx: Ctx, serve, pool, res: Result, n_calls: int) -> None:
    """`n_calls` calls under the device trace -> the per-layer readers'
    inputs in res.layer, busy and window, the breakdown."""
    from gator_tpu_torch.nn import fused_attention
    dev = torch.device(ctx.device)
    path = osp.join(ctx.scratch, f"trace-{ctx.cell}.json")
    counters = ("launches", "short_launches")
    before = {c: getattr(fused_attention, c, 0) for c in counters}
    by_dim0 = dict(getattr(fused_attention, "launches_by_dim", {}))
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
    k3 = {c: (getattr(fused_attention, c, 0) - before[c]) / n_calls
          for c in counters}
    by_dim = {str(d): (n - by_dim0.get(d, 0)) / n_calls for d, n in
              getattr(fused_attention, "launches_by_dim", {}).items()}
    res.layer.update(trace=tr, launches=info, traced_calls=n_calls,
                     k3_launches_per_call=k3["launches"])
    res.busy_s, res.window_s = busy_s(tr), tr.window_s
    res.breakdown = dict(breakdown(tr), launches_per_call={
        "fused_attention": k3["launches"],
        "fused_attention_short": k3["short_launches"],
        "fused_attention_by_head_dim": by_dim})


def run(ctx: Ctx) -> Result:
    cfg, mix, dev = ctx.cfg, ctx.mix, torch.device(ctx.device)
    dtype = DTYPES[cfg["precision"]]
    b = mix["batch"]
    assets, model, w = build_model(cfg, dev, ctx.seed, dtype)
    serve = make_program(model, dtype)
    pool = make_pool(ctx.seed, mix["pool_batches"], b, cfg, dev)
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
                     crops_per_s=n * b / elapsed)

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
    """The control: the reference computed in fp8 where the program
    computes in bf16 (ref.FP8Held: the backbone's, the decoder's and the
    head's products' operands, and every tensor the program holds between
    operations; SMPL stays f32, as the program's does), on the crops the
    cell's run with `seed` would judge, held to the same numbers."""
    if kind != "fp8":
        raise ValueError(f"unknown control {kind!r}")
    dev = torch.device(device)
    assets, model, w = build_model(cfg, dev, seed, DTYPES[cfg["precision"]])
    del model
    tables = ref.tables_of(assets, dev)
    pool = make_pool(seed, mix["pool_batches"], mix["batch"], cfg, dev)
    idx = sample_calls(seed, mix["sample_calls"], mix["sample_range"])
    inputs = [pool[i % len(pool)] for i in idx]
    blk = mix["ref_block"]
    outs = []
    with torch.no_grad():
        for x in inputs:
            parts = [ref.forward(w, tables, cfg, x[i:i + blk],
                                 prec=ref.FP8Held)
                     for i in range(0, x.shape[0], blk)]
            outs.append(tuple(torch.cat([p[k] for p in parts])
                              for k in range(3)))
    return compare(outs, inputs, w, tables, cfg, blk), {}
