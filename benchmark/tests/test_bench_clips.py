"""The MotionBERT clip cell: found by name, its readers on a canned trace,
and small CPU runs of `serve_clips` (the cell's full widths, a batch of
two clips, the program's plain attention): a sound run is correct; an
altered answer, half of the batch left out and the fp8 control are not."""
import json

import pytest
import torch

from benchmark.core import check, launches, mb_counts, spec
from benchmark.core.context import Ctx
from benchmark.metrics import program_marks
from benchmark.tests.cells import SEED

CELL = "serve-clip16-b128.motionbert-mesh-h36m17"
METRICS = ("k3_roofline.clip", "mb_smpl_ms.clip", "mb_rest_ms.clip",
           "mb_serve_mfu", "device_idle_pct.clip")
BASE = 1_000_000_000_000
US = 1000                                       # ns


def test_cell_resolves_by_name():
    parts = spec.resolve(CELL)
    assert parts["driver"].__name__ == "benchmark_driver_serve_clips"
    assert parts["config"]["name"] == "motionbert-mesh-h36m17"
    assert parts["traffic"]["batch"] == 128
    bench = parts["bench"]
    assert [m["name"] for m in spec.per_layer(bench, CELL)] == list(METRICS)
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == {
        "serve_poses_per_s", "serve_call_p95_ms", "setup_s"}
    # serve_clips' model spec agrees with its frozen recipe
    mspec = parts["driver"].model_spec(parts["config"])
    assert (mspec.dim_feat, mspec.depth, mspec.hidden_dim) == (512, 5, 1024)


def test_counts_match_the_worked_sizes():
    d = mb_counts.dims(spec.config("motionbert-mesh-h36m17"))
    assert mb_counts.block_dense(d) == 2 * 4_194_304
    assert mb_counts.frame(d) == pytest.approx(1.48e9, rel=0.01)
    assert mb_counts.k3_bytes(d, 128) / 20 == pytest.approx(142.6e6,
                                                            rel=1e-3)
    assert mb_counts.k3_launches(d) == 20


def ev(name, ts, dur, cat="kernel", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned(tmp_path, monkeypatch):
    """One call: window 0..100 us, the program's serve span 2..60 with
    serve.mb_smpl 40..60; launches at 5 (K3), 10 (a GEMM), 45 (SMPL)."""
    from benchmark.core import trace
    events = [
        ev("cudaLaunchKernel", 5, 1, "cuda_runtime", 1),
        ev("cudaLaunchKernel", 10, 1, "cuda_runtime", 2),
        ev("cudaLaunchKernel", 45, 1, "cuda_runtime", 3),
        ev("void gator::attn::attention_kernel<bf16, 64>(x)", 20, 10,
           corr=1),
        ev("cutlass gemm", 30, 15, corr=2),
        ev("at::native::elementwise_kernel<mul>", 50, 20, corr=3),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events,
                                "baseTimeNanoseconds": BASE}))
    marks = [("window", BASE, BASE + 100 * US),
             ("serve_call", BASE + 1 * US, BASE + 90 * US)]
    tr = trace.read_trace(str(path), marks, remove=False)
    prog = [("serve", BASE + 2 * US, BASE + 60 * US),
            ("serve.mb_smpl", BASE + 40 * US, BASE + 60 * US)]
    monkeypatch.setattr(program_marks, "program_marks", lambda: prog)
    return {"trace": tr, "launches": launches.read(str(path), tr.window),
            "traced_calls": 1, "batch": 128, "clip_len": 16,
            "cfg": spec.config("motionbert-mesh-h36m17"),
            "frames_per_s": 150_000.0}


def test_readers_on_a_canned_trace(tmp_path, monkeypatch):
    layer = canned(tmp_path, monkeypatch)
    read = {m: spec.metric_reader(m).read(layer) for m in METRICS}
    assert read["mb_smpl_ms.clip"] == pytest.approx(0.020)
    assert read["mb_rest_ms.clip"] == pytest.approx(0.015)
    assert read["device_idle_pct.clip"] == pytest.approx(55.0)  # 45 busy
    k3 = 0.8514e-3 / 10e-6 * 100                  # bytes-bound, 10 us
    assert read["k3_roofline.clip"] == pytest.approx(k3, rel=1e-3)
    assert read["mb_serve_mfu"] == pytest.approx(
        100 * 1.4809e9 * 150_000 / 989e12, rel=1e-3)


def test_readers_find_nothing_without_their_inputs(monkeypatch):
    monkeypatch.setattr(program_marks, "program_marks", lambda: None)
    for m in METRICS:
        assert spec.metric_reader(m).read({}) is None


def small_mix(**over):
    mix = dict(spec.traffic("serve-clip16-b128"))
    mix.update(batch=2, pool_batches=2, warmup_calls=1, sample_calls=2,
               sample_range=2, trace_calls=1, ref_block=2)
    mix.update(over)
    return mix


def clip_run(monkeypatch, wrap=None):
    drv = spec.driver("serve_clips")
    if wrap is not None:
        make = drv.make_program
        monkeypatch.setattr(drv, "make_program",
                            lambda model, dtype: wrap(make(model, dtype)))
    mix = small_mix()
    torch.set_num_threads(4)
    ctx = Ctx(cell=CELL, seed=SEED, seconds=0.3, trace=False,
              cfg=spec.config("motionbert-mesh-h36m17"), mix=mix,
              device="cpu")
    res = drv.run(ctx)
    return check.judge(res.values, mix["limits"])


def test_sound_run_is_correct(monkeypatch):
    ok, checks = clip_run(monkeypatch)
    assert ok, checks


def test_answer_altered(monkeypatch):
    def wrap(serve):
        def broken(x):
            verts, kp3d = serve(x)
            verts = verts.clone()
            verts[0] += 0.05                # one clip's meshes 5 cm off
            return verts, kp3d
        return broken
    ok, checks = clip_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_clip_rel_rms_max"]["value"] > \
        checks["mesh_clip_rel_rms_max"]["limit"]


def test_half_batch_left_out(monkeypatch):
    def wrap(serve):
        def broken(x):
            b = x.shape[0] // 2
            verts, kp3d = serve(x[:b])
            return (torch.cat([verts, torch.zeros_like(verts)]),
                    torch.cat([kp3d, torch.zeros_like(kp3d)]))
        return broken
    ok, checks = clip_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_rel_rms"]["value"] > checks["mesh_rel_rms"]["limit"]


def test_control_not_correct_small():
    torch.set_num_threads(4)
    mix = small_mix()
    values, _ = spec.driver("serve_clips").control(
        spec.config("motionbert-mesh-h36m17"), mix, SEED, "cpu", "fp8")
    ok, checks = check.judge(values, mix["limits"])
    assert not ok, checks


@pytest.mark.cuda
def test_control_not_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    mix = spec.traffic("serve-clip16-b128")
    for seed in (101, 102, 103):
        values, _ = spec.driver("serve_clips").control(
            spec.config("motionbert-mesh-h36m17"), mix, seed, "cuda", "fp8")
        ok, checks = check.judge(values, mix["limits"])
        assert not ok, checks
