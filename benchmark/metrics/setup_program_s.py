"""Seconds of the process inside the program's set-up spans (`setup.*`:
`assets.build_assets`, `nn.cuda_lib.load`'s first load of each library
with its nvcc build, `serving.serving_weights`), the union of their
intervals, so that a span nested in another counts once."""
from benchmark.core import trace
from benchmark.metrics import program_marks


def read(layer: dict):
    marks = program_marks.program_marks()
    setup = [(a / 1e3, b / 1e3) for name, a, b in marks or ()
             if name.startswith("setup.")]
    if not setup:
        return None
    return trace.union_us(setup) * 1e-6
