"""Small-size runs of the cells' drivers on the CPU, for the tests: the
cell's own code and limits at a batch of a few rows, the program's plain
versions in place of the kernels."""
from __future__ import annotations

import torch

from benchmark.core import spec
from benchmark.core.context import Ctx

SEED = 2**31 + 7


def parts(cell: str) -> dict:
    """A cell's parts by its name, `<traffic>.<config>`: from
    BENCHMARK.json, or from the files alone for a mix that waits for its
    cell (PERF.md, open questions)."""
    traffic, config = cell.split(".", 1)
    mix = spec.traffic(traffic)
    return {"config": spec.config(config), "traffic": mix,
            "driver": spec.driver(mix["driver"])}


def small_mix(cell: str, **over) -> dict:
    mix = dict(parts(cell)["traffic"])
    if mix["driver"] == "serve_closed":
        mix.update(batch=6, pool_batches=3, warmup_calls=1, sample_calls=2,
                   sample_range=3, trace_calls=1, ref_block=6)
    else:
        mix.update(batch=4, synthetic_n=16, warmup_steps=0, trace_steps=1)
    mix.update(over)
    return mix


def small_recipe(monkeypatch, driver, precision=None):
    """The train driver's recipe at the small mix's batch (and, for the
    f32 witness, another precision)."""
    from gator_tpu_torch.config import load_config

    def load(mix, cfg, seed):
        train = {"batch_size": mix["batch"]}
        if precision:
            train["precision"] = precision
        return load_config(spec.traffic_file(mix["recipe"]),
                           {"seed": int(seed), "TRAIN": train})
    monkeypatch.setattr(driver, "load_recipe", load)


def run(cell: str, mix: dict, cfg: dict = None, seconds: float = 0.2):
    got = parts(cell)
    torch.set_num_threads(4)
    ctx = Ctx(cell=cell, seed=SEED, seconds=seconds, trace=False,
              cfg=cfg or got["config"], mix=mix, device="cpu")
    return got["driver"].run(ctx)
