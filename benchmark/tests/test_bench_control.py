"""The control comes out not correct: the plain reference computed with
fp8 operands in the program's place, held to each cell's numbers and
limits. On the CPU at a small batch; marked `cuda`, at the cell's own
size on the card, on three seeds (the readings PERF.md gives)."""
import pytest
import torch

from benchmark.core import check
from benchmark.tests import cells

CELLS = ["serve-b2048.gator-h36m17", "train2-flagship-b512.gator-coco19",
         "train2-gtinput-b512.gator-h36m17"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_small(cell, monkeypatch):
    parts = cells.parts(cell)
    drv = parts["driver"]
    mix = cells.small_mix(cell)
    if mix["driver"] != "serve_closed":
        cells.small_recipe(monkeypatch, drv)
    torch.set_num_threads(4)
    values, _ = drv.control(parts["config"], mix, cells.SEED, "cpu", "fp8")
    ok, checks = check.judge(values, mix["limits"])
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    parts = cells.parts(cell)
    for seed in (101, 102, 103):
        values, _ = parts["driver"].control(
            parts["config"], parts["traffic"], seed, "cuda", "fp8")
        ok, checks = check.judge(values, parts["traffic"]["limits"])
        assert not ok, checks
