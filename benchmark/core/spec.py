"""Where the benchmark finds each part of a cell, by name.

`BENCHMARK.json` at the root of the checkout lists the cells. A cell
names a configuration and a traffic mix; each lives in a file of its own:

  benchmark/configs/<config>.json   the model configuration (and the
                                    frozen recipe YAML it names)
  benchmark/traffic/<traffic>.json  the traffic mix: a driver's name and
                                    that driver's parameters
  benchmark/drivers/<driver>.py     one driver per loop kind
  benchmark/metrics/<metric>.py     one reader per per-layer metric

A later change adds a cell, a mix or a metric by adding files and entries;
no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os.path as osp
import sys
from types import ModuleType
from typing import Dict, List

BENCH = osp.dirname(osp.dirname(osp.abspath(__file__)))
ROOT = osp.dirname(BENCH)
SCRATCH = osp.join(ROOT, "build", "benchmark")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(osp.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    cfg = load_json(osp.join(BENCH, "configs", f"{name}.json"))
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself "
                         f"{cfg.get('name')!r}")
    return cfg


def config_file(rel: str) -> str:
    """A file beside the configurations (a frozen recipe)."""
    return osp.join(BENCH, "configs", rel)


def traffic(name: str) -> dict:
    mix = load_json(osp.join(BENCH, "traffic", f"{name}.json"))
    if "driver" not in mix:
        raise ValueError(f"traffic/{name}.json names no driver")
    return mix


def traffic_file(rel: str) -> str:
    return osp.join(BENCH, "traffic", rel)


def load_module(path: str, modname: str) -> ModuleType:
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not osp.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return load_module(osp.join(BENCH, "drivers", f"{name}.py"),
                       f"benchmark_driver_{name}")


def metric_reader(name: str) -> ModuleType:
    return load_module(osp.join(BENCH, "metrics", f"{name}.py"),
                       "benchmark_metric_" + name.replace(".", "__"))


def _covers(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _covers(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics of a cell: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def resolve(cell_name: str, bench: Dict = None) -> Dict:
    """-> {"bench", "cell", "config", "traffic", "driver"} of a cell."""
    bench = benchmark() if bench is None else bench
    w = cell(bench, cell_name)
    mix = traffic(w["traffic"])
    return {"bench": bench, "cell": w, "config": config(w["config"]),
            "traffic": mix, "driver": driver(mix["driver"])}
