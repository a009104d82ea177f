"""Host ms a serving call spends inside the program's `serve` span
(`serving.make_serving_fn`: its stages' dispatch, the launches included),
mean over the traced calls."""
from benchmark.metrics import program_marks


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None:
        return None
    spans = program_marks.placed(tr, program_marks.program_marks())
    if spans is None:
        return None
    serve = [b - a for a, b, name in spans if name == "serve"]
    return sum(serve) / len(serve) / 1e3
