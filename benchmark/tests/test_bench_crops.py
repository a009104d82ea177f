"""The HMR 2.0 crop cell: found by name, its counts at the worked sizes,
its readers on a canned trace, and small CPU runs of `serve_crops` (a
small model of the configuration's kind: embed 160, 2 heads of 80, depth
2, 64 x 64 crops; a batch of two crops, the program's plain attention): a
sound run is correct; an altered answer, half of the batch left out and
the fp8 control are not."""
import json

import pytest
import torch

from benchmark.core import check, hmr2_counts, launches, spec
from benchmark.core.context import Ctx
from benchmark.metrics import program_marks
from benchmark.tests.cells import SEED

CELL = "serve-crop-b64.hmr2-vith16-256x192"
CONFIG = "hmr2-vith16-256x192"
METRICS = ("hmr_serve_mfu", "k3_roofline.crop", "hmr_vit_roofline.crop",
           "hmr_decoder_ms.crop", "hmr_smpl_ms.crop")
BASE = 1_000_000_000_000
US = 1000                                       # ns


def test_cell_resolves_by_name():
    parts = spec.resolve(CELL)
    assert parts["driver"].__name__ == "benchmark_driver_serve_crops"
    assert parts["config"]["name"] == CONFIG
    assert parts["traffic"]["batch"] == 64
    bench = parts["bench"]
    assert [m["name"] for m in spec.per_layer(bench, CELL)] == list(METRICS)
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == {
        "serve_poses_per_s", "serve_call_p95_ms", "setup_s"}
    # serve_crops' model spec agrees with its frozen recipe
    mspec = parts["driver"].model_spec(parts["config"])
    assert (mspec.embed_dim, mspec.depth, mspec.num_heads, mspec.dec_dim,
            mspec.grid) == (1280, 32, 16, 1024, (16, 12))


def test_recipe_disagreement_raises(monkeypatch):
    drv = spec.driver("serve_crops")
    cfg = dict(spec.config(CONFIG), depth=24)
    with pytest.raises(ValueError):
        drv.model_spec(cfg)


def test_counts_match_the_worked_sizes():
    d = hmr2_counts.dims(spec.config(CONFIG))
    assert d["n"] == 192
    assert hmr2_counts.backbone(d) == pytest.approx(247.9e9, rel=1e-3)
    assert hmr2_counts.crop(d) == pytest.approx(251e9, rel=2e-3)
    assert 64 * hmr2_counts.crop(d) == pytest.approx(16.1e12, rel=2e-3)
    # a backbone launch of K3 at 64 crops: q, k, v and out, bf16
    per = hmr2_counts.k3_launch_bytes(d, 64)
    assert per["vit"] == 4 * 64 * 192 * 1280 * 2
    assert per["vit"] == pytest.approx(125.8e6, rel=1e-3)
    assert hmr2_counts.k3_bytes(d, 64) == pytest.approx(4.18e9, rel=2e-3)
    assert hmr2_counts.backbone_params(d) == pytest.approx(630e6, rel=1e-2)


def ev(name, ts, dur, cat="kernel", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned(tmp_path, monkeypatch):
    """One call: window 0..100 us, the program's serve span 2..80 with
    serve.hmr_patch 2..4, serve.hmr_vit 4..40, serve.hmr_decoder 40..60,
    serve.hmr_smpl 60..80; launches at 2 (the conv), 5 (K3), 10 (a GEMM),
    45 (the decoder's K3), 65 (SMPL). The program's marks are placed up to
    1 us early (program_marks.placed), so the conv's launch opens its
    span."""
    from benchmark.core import trace
    events = [
        ev("cudaLaunchKernel", 2, 1, "cuda_runtime", 1),
        ev("cudaLaunchKernel", 5, 1, "cuda_runtime", 2),
        ev("cudaLaunchKernel", 10, 1, "cuda_runtime", 3),
        ev("cudaLaunchKernel", 45, 1, "cuda_runtime", 4),
        ev("cudaLaunchKernel", 65, 1, "cuda_runtime", 5),
        ev("cudnn conv", 4, 4, corr=1),
        ev("void gator::attn::attention_kernel<bf16, 80, false>(x)", 8, 10,
           corr=2),
        ev("nvjet gemm", 18, 20, corr=3),
        ev("void gator::attn::attention_kernel<bf16, 64, false>(x)", 46, 2,
           corr=4),
        ev("at::native::elementwise_kernel<mul>", 66, 5, corr=5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events,
                                "baseTimeNanoseconds": BASE}))
    marks = [("window", BASE, BASE + 100 * US),
             ("serve_call", BASE + 1 * US, BASE + 90 * US)]
    tr = trace.read_trace(str(path), marks, remove=False)
    prog = [("serve", BASE + 2 * US, BASE + 80 * US),
            ("serve.hmr_patch", BASE + 2 * US, BASE + 4 * US),
            ("serve.hmr_vit", BASE + 4 * US, BASE + 40 * US),
            ("serve.hmr_decoder", BASE + 40 * US, BASE + 60 * US),
            ("serve.hmr_smpl", BASE + 60 * US, BASE + 80 * US)]
    monkeypatch.setattr(program_marks, "program_marks", lambda: prog)
    return {"trace": tr, "launches": launches.read(str(path), tr.window),
            "traced_calls": 1, "batch": 64, "cfg": spec.config(CONFIG),
            "crops_per_s": 2_000.0}


def test_readers_on_a_canned_trace(tmp_path, monkeypatch):
    layer = canned(tmp_path, monkeypatch)
    read = {m: spec.metric_reader(m).read(layer) for m in METRICS}
    d = hmr2_counts.dims(layer["cfg"])
    assert read["hmr_smpl_ms.crop"] == pytest.approx(0.005)
    assert read["hmr_decoder_ms.crop"] == pytest.approx(0.002)
    k3_s = max(hmr2_counts.k3_ops(d, 64) / 989e12,
               hmr2_counts.k3_bytes(d, 64) / 3.35e12)
    assert read["k3_roofline.crop"] == pytest.approx(100 * k3_s / 12e-6,
                                                     rel=1e-6)
    vit_s = 64 * hmr2_counts.backbone(d) / 989e12        # ops-bound
    assert read["hmr_vit_roofline.crop"] == pytest.approx(
        100 * vit_s / 34e-6, rel=1e-6)                   # 4 + 10 + 20 us
    assert read["hmr_serve_mfu"] == pytest.approx(
        100 * hmr2_counts.crop(d) * 2_000 / 989e12, rel=1e-9)


def test_readers_find_nothing_without_their_inputs(monkeypatch):
    monkeypatch.setattr(program_marks, "program_marks", lambda: None)
    for m in METRICS:
        assert spec.metric_reader(m).read({}) is None


SMALL = dict(image_size=64, img_h=64, img_w=48, embed_dim=160, num_heads=2,
             depth=2, context_dim=160, dec_dim=64, dec_depth=2, dec_heads=2,
             dec_dim_head=32, dec_mlp_dim=64)


def small_mix(**over):
    mix = dict(spec.traffic("serve-crop-b64"))
    mix.update(batch=2, pool_batches=2, warmup_calls=1, sample_calls=2,
               sample_range=2, trace_calls=1, ref_block=2)
    mix.update(over)
    return mix


def small_cell(monkeypatch, wrap=None):
    """serve_crops with the small configuration: its recipe check, which
    holds the published widths, is left out."""
    drv = spec.driver("serve_crops")
    monkeypatch.setattr(drv, "check_recipe", lambda cfg: None)
    if wrap is not None:
        make = drv.make_program
        monkeypatch.setattr(drv, "make_program",
                            lambda model, dtype: wrap(make(model, dtype)))
    return drv, dict(spec.config(CONFIG), **SMALL)


def crop_run(monkeypatch, wrap=None):
    drv, cfg = small_cell(monkeypatch, wrap)
    mix = small_mix()
    torch.set_num_threads(4)
    ctx = Ctx(cell=CELL, seed=SEED, seconds=0.3, trace=False, cfg=cfg,
              mix=mix, device="cpu")
    res = drv.run(ctx)
    return check.judge(res.values, mix["limits"])


def test_sound_run_is_correct(monkeypatch):
    ok, checks = crop_run(monkeypatch)
    assert ok, checks


def test_answer_altered(monkeypatch):
    def wrap(serve):
        def broken(x):
            verts, joints, cam_t = serve(x)
            verts = verts.clone()
            verts[0] += 0.05                # one crop's mesh 5 cm off
            return verts, joints, cam_t
        return broken
    ok, checks = crop_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_row_rel_rms_max"]["value"] > \
        checks["mesh_row_rel_rms_max"]["limit"]


def test_half_batch_left_out(monkeypatch):
    def wrap(serve):
        def broken(x):
            b = x.shape[0] // 2
            return tuple(torch.cat([t, torch.zeros_like(t)])
                         for t in serve(x[:b]))
        return broken
    ok, checks = crop_run(monkeypatch, wrap)
    assert not ok
    assert checks["mesh_rel_rms"]["value"] > checks["mesh_rel_rms"]["limit"]


def test_control_not_correct_small(monkeypatch):
    drv, cfg = small_cell(monkeypatch)
    torch.set_num_threads(4)
    mix = small_mix()
    values, _ = drv.control(cfg, mix, SEED, "cpu", "fp8")
    ok, checks = check.judge(values, mix["limits"])
    assert not ok, checks


@pytest.mark.cuda
def test_control_not_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    mix = spec.traffic("serve-crop-b64")
    for seed in (101, 102, 103):
        values, _ = spec.driver("serve_crops").control(
            spec.config(CONFIG), mix, seed, "cuda", "fp8")
        ok, checks = check.judge(values, mix["limits"])
        assert not ok, checks
