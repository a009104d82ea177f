"""The import checks."""
import os.path as osp

from benchmark.core import guard, spec


def test_names_compared_whole():
    got = guard.loaded_banned(["gator_tpu_torch", "gator_tpu_torch.nn",
                               "jaxtyping", "flaxen", "numpy", "optax",
                               "jax.numpy", "gator_tpu", "gator_tpu.models"])
    assert got == ["gator_tpu", "gator_tpu.models", "jax.numpy", "optax"]


def test_reference_imports_nothing_banned():
    ref = osp.join(spec.BENCH, "reference")
    assert guard.reference_imports(ref) == []


def test_static_check_sees_a_hit(tmp_path):
    (tmp_path / "bad.py").write_text(
        "import torch\nfrom gator_tpu_torch.nn import x\nimport jax.numpy\n")
    assert guard.reference_imports(str(tmp_path)) == [
        ("bad.py", "gator_tpu_torch.nn"), ("bad.py", "jax.numpy")]


def test_harness_files_import_no_jax():
    """No file of the benchmark imports JAX or the JAX package."""
    import os
    for root, _, files in os.walk(spec.BENCH):
        for fn in files:
            if fn.endswith(".py"):
                for m in guard.imports_of(osp.join(root, fn)):
                    assert guard.top_level(m) not in guard.BANNED, (fn, m)
