"""Stage-2 training steps back to back, fed by the session's pipeline.

Set-up: the traffic's frozen recipe (`recipe`) loaded by the port's
`config.load_config` with --seed as its seed, the port's seeded assets,
`cli.common.Session(cfg, is_train=True, synthetic=True)` over stand-in
tables of `synthetic_n` rows each, its optimizer and train step (K4/K5,
wrapped for the session's in-step input mode), the benchmark's weights
loaded into the step's model. The step object then takes its first
`check_steps` steps on the pipeline's first batches (the window's own call
and feed; the assembly and the inner step are called as the wrapped step
composes them, so that the assembled batch can be kept), and
`warmup_steps` more. The window: steps back to back as `cli/train.py`
drives them (epochs follow one another; the edge term is gated by
epoch), with no synchronisation until the window closes.

After the window, the plain float32 reference works out the first steps'
inputs from the raw tables and takes those steps from the same weights;
the numbers compared are in `compare`.

Traffic keys: recipe, gt_in_step, batch, synthetic_n, check_steps,
warmup_steps, trace_steps, limits.
"""
from __future__ import annotations

import os.path as osp
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import spec, weights
from benchmark.core.context import Ctx, Result
from benchmark.core.trace import breakdown, busy_s, read_trace, traced
from benchmark.reference import inputs as ref_inputs
from benchmark.reference import model as ref
from benchmark.reference import smpl as ref_smpl
from benchmark.reference import train as ref_train

BETA1 = 0.9


def load_recipe(mix: dict, cfg: dict, seed: int):
    from gator_tpu_torch.config import load_config
    rc = load_config(spec.traffic_file(mix["recipe"]), {"seed": int(seed)})
    want = {"DATASET.input_joint_set": cfg["input_joint_set"],
            "MODEL.alpha": cfg["mdr"]["alpha"],
            "MODEL.embed_dim": cfg["gat"]["embed_dim"],
            "MODEL.depth": cfg["gat"]["depth"],
            "TRAIN.precision": cfg["precision"],
            "TRAIN.batch_size": mix["batch"]}
    for key, v in want.items():
        sec, k = key.split(".")
        got = getattr(getattr(rc, sec), k)
        if got != v:
            raise ValueError(f"{mix['recipe']}: {key} is {got!r}; the cell "
                             f"states {v!r}")
    return rc


class Feed:
    """The session's pipeline over epochs, as cli/train.py walks it."""

    def __init__(self, sess, rc):
        self.sess, self.rc = sess, rc
        self.epoch = rc.TRAIN.begin_epoch
        self._open()

    def _open(self):
        self.sess.pipeline.set_epoch(self.epoch)
        self.it = iter(self.sess.pipeline)

    @property
    def edge_on(self) -> float:
        return 1.0 if self.epoch > self.rc.TRAIN.edge_loss_start else 0.0

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self._open()
            return next(self.it)

    def close(self):
        self.it.close()


def build(ctx: Ctx):
    """-> (recipe, assets, session, state, step, the benchmark's
    weights)."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.cli.common import Session

    cfg, mix = ctx.cfg, ctx.mix
    dev = torch.device(ctx.device)
    rc = load_recipe(mix, cfg, ctx.seed)
    assets = build_assets(cfg["input_joint_set"], data_dirs=[])
    sess = Session(rc, synthetic=True, assets=assets,
                   synthetic_n=mix["synthetic_n"], device=dev,
                   is_train=True)
    if sess.gt_in_step != mix["gt_in_step"]:
        raise ValueError(f"the session runs gt_in_step={sess.gt_in_step}; "
                         f"the mix states {mix['gt_in_step']}")
    state, step = sess.make_train_step(sess.make_optimizer())
    w = weights.make(state.model.state_dict(), ctx.seed, dev)
    weights.load_into(state.model, w)
    return rc, assets, sess, state, step, w


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_steps(state, step, feed: Feed, seed: int, n: int):
    """The step object's first n steps -> (feeds, assembled batches,
    losses, step 1's gradient norms by leaf, the change's norms)."""
    named = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    feeds, asm, losses, grad1 = [], [], [], {}
    for s in range(n):
        batch = feed.next()
        a = step.assemble(state, batch, seed, feed.edge_on)
        m = step.inner(state, a, seed, feed.edge_on)
        feeds.append(batch)
        asm.append(a)
        losses.append(m["loss"])
        if s == 0:
            opt = state.optimizer
            grad1 = _norms({k: opt.state[p]["mu"] / (1 - BETA1)
                            for k, p in named.items() if p in opt.state})
    delta = _norms({k: p.detach() - start[k] for k, p in named.items()})
    return feeds, asm, [float(x) for x in losses], grad1, delta


def window(ctx: Ctx, state, step, feed: Feed, seed: int, dev):
    n = 0
    t_open = ctx.open_window()
    while time.perf_counter() - t_open < ctx.seconds:
        with ctx.spans.span("input_wait"):
            batch = feed.next()
        with ctx.spans.span("step"):
            step(state, batch, seed, feed.edge_on)
        n += 1
    _sync(dev)
    return n, time.perf_counter() - t_open


def compare(program: Dict, reference: Dict, asm_p: List, asm_r: List
            ) -> Dict[str, float]:
    """The numbers compared.

    The input assembly, judged by itself (the reference's own assembly
    from the raw tables against the program's, batch by batch): the 2D
    input's widest gap (standardised units; with detector noise, from the
    program's table of input joints, which is judged apart), the targets'
    widest gaps (m, mm) and the share of fit gates that differ.

    The steps, which the reference takes on the program's assembled
    batches: each step's loss as a share of the reference's; step 1's
    gradient and the change over the steps by the worst leaf's gap of
    norms (train.norm_gap); the change over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (the rest move
    under Adam by round-off alone)."""
    def widest(key):
        return max(float((a[key].float() - b[key].float()).abs().max())
                   for a, b in zip(asm_p, asm_r))

    gates = [float(((a[k] > 0.5) != (b[k] > 0.5)).float().mean())
             for a, b in zip(asm_p, asm_r)
             for k in ("mesh_valid", "reg_valid", "lift_valid")]
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(program["loss"], reference["loss"]))
    g_ref = reference["grad1"]
    return {
        "pose2d_max_abs": widest("pose2d"),
        "mesh_target_max_abs_m": widest("mesh"),
        "lift_target_max_abs_mm": widest("lift_pose3d"),
        "reg_target_max_abs_mm": widest("reg_pose3d"),
        "gates_differ_share": max(gates),
        "loss_rel_max": loss_gap,
        "grad1_norm_gap": ref_train.norm_gap(program["grad1"], g_ref)[0],
        "delta_norm_gap": ref_train.norm_gap(program["delta"],
                                             reference["delta"],
                                             moving_leaves(g_ref))[0],
        "grad1_norm_gap_median": ref_train.norm_gap(
            program["grad1"], g_ref, median=True)[0],
        "delta_norm_gap_median": ref_train.norm_gap(
            program["delta"], reference["delta"], moving_leaves(g_ref),
            median=True)[0],
    }


def moving_leaves(g_ref: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(g_ref.values())))
    return [k for k, v in g_ref.items() if v >= 1e-3 * med]


def look(program: Dict, reference: Dict) -> Dict[str, str]:
    """The leaves that set the worst-leaf gaps."""
    g_ref = reference["grad1"]
    return {"grad1_worst_leaf": ref_train.norm_gap(program["grad1"],
                                                   g_ref)[1],
            "delta_worst_leaf": ref_train.norm_gap(
                program["delta"], reference["delta"],
                moving_leaves(g_ref))[1]}


def start_check(rows, feeds, given) -> Dict[str, float]:
    """The program's packed table judged by itself on the fed rows: its
    input joints (px) and crop areas (relative) against the reference's
    own."""
    key = "row" if "row" in feeds[0] else "idx"
    fed = torch.cat([f[key].reshape(-1) for f in feeds]).to(rows.device)
    own = rows.take(fed)
    at = fed.long().cpu().numpy()
    img = torch.as_tensor(given["img_in"][at], device=rows.device)
    area = torch.as_tensor(given["area"][at], device=rows.device)
    return {"input_joints_max_abs_px": float(
                (img - own["img_in"]).abs().max()),
            "crop_area_rel_max": float(
                ((area - own["area"]).abs() / own["area"]).max())}


def reference_steps(ctx: Ctx, rc, assets, datasets, feeds, seed,
                    given=None):
    """-> (the reference's own assembly of the fed batches, the start
    numbers, steps(w0, batches[, prec]): its steps from given weights).
    `given`: the program's packed table's input joints and crop areas by
    global row (see inputs.assemble), judged here against the reference's
    own."""
    dev = torch.device(ctx.device)
    ref.no_tf32()
    joint_set = ctx.cfg["input_joint_set"]
    tb = ref_smpl.tables_of(assets, joint_set, dev)
    coco = rc.DATASET.input_joint_set == "coco"
    noise_on = not rc.DATASET.use_gt_input
    if noise_on and not coco:
        raise NotImplementedError("the reference draws COCO detector "
                                  "noise only")
    shape = tuple(rc.MODEL.input_shape)
    key = "row" if "row" in feeds[0] else "idx"
    rows = ref_inputs.Rows(tb, datasets, list(rc.DATASET.train_list),
                           torch.cat([f[key].reshape(-1).to(dev)
                                      for f in feeds]), coco, shape)
    asm = [ref_inputs.assemble(rows, f, seed, s, tb, shape, noise_on, given)
           for s, f in enumerate(feeds)]
    start = start_check(rows, feeds, given) if given is not None else {}
    j_target = tb["j_h36m"] if rc.DATASET.target_joint_set == "human36" \
        else tb["j_coco"]
    if rc.TRAIN.optimizer != "adam":
        raise NotImplementedError("the reference follows Adam only")
    lw = {"normal": rc.MODEL.normal_loss_weight,
          "edge": rc.MODEL.edge_loss_weight,
          "joint": rc.MODEL.joint_loss_weight}
    edge_on = 1.0 if rc.TRAIN.begin_epoch > rc.TRAIN.edge_loss_start \
        else 0.0
    tables = ref.tables_on(ref.arrays_of(assets, joint_set), dev)
    steps = _steps_fn(ctx, rc, tables, tb, j_target, lw, edge_on, seed)
    steps.rows = rows
    return asm, start, steps


def _steps_fn(ctx, rc, tables, tb, j_target, lw, edge_on, seed):
    return (lambda w0, batches, prec=ref.F32: ref_train.run_steps(
        w0, tables, ctx.cfg, batches, seed, rc.TRAIN.lr, tb["faces"],
        j_target, lw, edge_on, prec=prec))


def packed_given(sess):
    """The program's packed table's input joints and crop areas, which the
    reference follows through the detector noise (inputs.assemble)."""
    if sess.gt_in_step not in ("packed", "device"):
        return None
    pt = sess.packed_table()
    return {"img_in": pt.joint_img_input, "area": pt.crop_area}


def run(ctx: Ctx) -> Result:
    if ctx.chips != 1:
        raise ValueError("train_steps drives one card")
    dev, mix = torch.device(ctx.device), ctx.mix
    seed = int(ctx.seed)
    rc, assets, sess, state, step, w0 = build(ctx)
    feed = Feed(sess, rc)
    feeds, asm_p, loss_p, grad1_p, delta_p = check_steps(
        state, step, feed, seed, mix["check_steps"])
    for _ in range(mix["warmup_steps"]):
        step(state, feed.next(), seed, feed.edge_on)
    _sync(dev)

    n, elapsed = window(ctx, state, step, feed, seed, dev)
    host = np.asarray(ctx.spans.times["step"]) * 1e3
    print(f"window: {n} steps in {elapsed:.3f} s; step host ms median "
          f"{np.median(host):.2f} p90 {np.percentile(host, 90):.2f} max "
          f"{host.max():.2f}; input wait ms total "
          f"{1e3 * sum(ctx.spans.times['input_wait']):.1f}", file=sys.stderr)
    res = Result(attempted=n, failed=0)
    b = mix["batch"]
    res.e2e["train_poses_per_s"] = n * b / elapsed
    times = ctx.spans.times
    res.layer.update(
        cfg=ctx.cfg, batch=b, chips=1,
        poses_per_s=res.e2e["train_poses_per_s"],
        step_host_ms=1e3 * float(np.mean(times["step"])),
        input_wait_ms=1e3 * float(np.mean(times["input_wait"])))

    if ctx.trace:
        path = osp.join(ctx.scratch, f"trace-{ctx.cell}.json")
        ctx.spans.tracing = True
        with traced(path):
            with ctx.spans.span("window"):
                for _ in range(mix["trace_steps"]):
                    with ctx.spans.span("input_wait"):
                        batch = feed.next()
                    with ctx.spans.span("step"):
                        step(state, batch, seed, feed.edge_on)
                with ctx.spans.span("sync"):
                    _sync(dev)
        ctx.spans.tracing = False
        tr = read_trace(path, ctx.spans.marks)
        res.layer.update(trace=tr, traced_steps=mix["trace_steps"])
        res.busy_s, res.window_s = busy_s(tr), tr.window_s
        res.breakdown = breakdown(tr)
    feed.close()

    res.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    datasets, given = list(sess.datasets), packed_given(sess)
    del state, step, sess, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    asm_p = [{k: v.float() for k, v in a.items()} for a in asm_p]
    asm_r, start, steps = reference_steps(ctx, rc, assets, datasets, feeds,
                                          seed, given)
    out = steps(w0, asm_p)
    prog = {"loss": loss_p, "grad1": grad1_p, "delta": delta_p}
    res.values = dict(start, **compare(prog, out, asm_p, asm_r))
    print(f"look: {look(prog, out)}", file=sys.stderr)
    res.limits = dict(mix["limits"])
    return res


def _half(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def _altered(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One answer of the assembly altered where it is produced: row 0's
    2D input, targets and mesh gate."""
    out = {k: v.clone() for k, v in batch.items()}
    out["pose2d"][0] += 0.1
    out["mesh"][0] += 0.01
    out["lift_pose3d"][0] += 10.0
    out["reg_pose3d"][0] += 10.0
    out["mesh_valid"][0] = 1.0 - out["mesh_valid"][0]
    return out


def control(cfg: dict, mix: dict, seed: int, device, kind: str
            ) -> Dict[str, float]:
    """The reference in the program's place on the cell's first batches,
    held to the same numbers: "fp8" computes it with fp8 operands (the
    control); faults the numbers must see: "half" takes each step's mean
    over the first half of the batch, "altered" alters one row of each assembled batch and of
    the packed table (`_altered`). -> (values, look)."""
    from benchmark.reference import lowp
    ctx = Ctx(cell="control", seed=seed, seconds=0.0, trace=False, cfg=cfg,
              mix=mix, device=device)
    rc, assets, sess, state, step, w0 = build(ctx)
    feed = Feed(sess, rc)
    feeds = [feed.next() for _ in range(mix["check_steps"])]
    feed.close()
    datasets, given = list(sess.datasets), packed_given(sess)
    del state, step, sess, feed
    asm, start, steps = reference_steps(ctx, rc, assets, datasets, feeds,
                                        seed, given)
    want = steps(w0, asm)
    fed = asm
    if kind == "fp8":
        got = steps(w0, asm, lowp.FP8Train)
    elif kind == "half":
        got = steps(w0, [_half(a) for a in asm])
    elif kind == "altered":
        fed = [_altered(a) for a in asm]
        got = steps(w0, fed)
        if given is not None:           # and one row of the packed table
            r0 = int(feeds[0]["row"].reshape(-1)[0])
            given = {k: v.copy() for k, v in given.items()}
            given["img_in"][r0] += 1.0
            given["area"][r0] *= 1.05
            start = start_check(steps.rows, feeds, given)
    else:
        raise ValueError(f"unknown control {kind!r}")
    return dict(start, **compare(got, want, fed, asm)), look(got, want)
