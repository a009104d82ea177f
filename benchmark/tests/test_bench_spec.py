"""BENCHMARK.json against the contract's shape, and every part of every
cell found by name."""
import json
import os.path as osp
import re

import pytest

from benchmark.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
E2E = {"serve_poses_per_s", "serve_call_p95_ms", "setup_s"}
# cells whose files are here and which BENCHMARK.json does not hold yet
# (PERF.md, open questions), with the per-layer readers they would report
WAITING = {
    "train2-flagship-b512.gator-coco19": (
        "k5_roofline.train", "k4_roofline.train", "train_rest_ms",
        "train_mfu", "step_host_ms", "input_wait_ms",
        "device_idle_pct.train"),
    "train2-gtinput-b512.gator-h36m17": (
        "k5_roofline.train", "k4_roofline.train", "train_rest_ms",
        "train_mfu", "step_host_ms", "input_wait_ms",
        "device_idle_pct.train"),
}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/")
        assert osp.isfile(osp.join(spec.ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] == f"{w['traffic']}.{w['config']}"
        names.add(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    assert {m["name"] for m in bench["end_to_end"]} == E2E
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in E2E - {"setup_s"}


@pytest.mark.parametrize("part", ["config", "traffic", "driver", "metrics"])
def test_every_cell_resolves(bench, part):
    for w in bench["workloads"]:
        got = spec.resolve(w["name"], bench)
        if part == "config":
            assert got["config"]["name"] == w["config"]
            assert osp.isfile(spec.config_file(got["config"]["recipe"]))
        elif part == "traffic":
            assert "limits" in got["traffic"]
            if "recipe" in got["traffic"]:
                assert osp.isfile(spec.traffic_file(
                    got["traffic"]["recipe"]))
        elif part == "driver":
            assert callable(got["driver"].run)
            assert callable(got["driver"].control)
        else:
            e2e = {m["name"] for m in spec.end_to_end(bench, w["name"])}
            assert "setup_s" in e2e and len(e2e) >= 2
            layers = spec.per_layer(bench, w["name"])
            assert layers
            for m in layers:
                assert m["moves"] in e2e
                assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("cell", sorted(WAITING))
def test_waiting_cell_parts_resolve(bench, cell):
    """A waiting cell's files are found by name, so that adding it takes
    entries in BENCHMARK.json alone."""
    assert cell not in {w["name"] for w in bench["workloads"]}
    traffic, config = cell.split(".", 1)
    mix, cfg = spec.traffic(traffic), spec.config(config)
    assert cfg["name"] == config and "limits" in mix
    assert osp.isfile(spec.traffic_file(mix["recipe"]))
    assert osp.isfile(spec.config_file(cfg["recipe"]))
    drv = spec.driver(mix["driver"])
    assert callable(drv.run) and callable(drv.control)
    for name in WAITING[cell]:
        assert callable(spec.metric_reader(name).read)


def test_one_layer_name_per_layer(bench):
    """Metrics of one layer name it letter for letter the same."""
    by_prefix = {}
    for m in bench["per_layer"]:
        by_prefix.setdefault(m["layer"], []).append(m["name"])
    assert all(by_prefix.values())
