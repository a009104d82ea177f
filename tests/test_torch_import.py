"""Importing gator_tpu_torch and each of its modules pulls in neither JAX,
nor Triton, nor the JAX package, and builds no kernel (checked in a fresh
interpreter, since this test process has JAX loaded)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import pkgutil, sys
import gator_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gator_tpu_torch.__path__,
                                               "gator_tpu_torch.")]
for name in names:
    __import__(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton", "gator_tpu")]
from gator_tpu_torch.nn import cuda_lib
print(len(names), bad, sorted(cuda_lib._LOADED))
"""


def test_import_pulls_in_no_jax_and_no_triton():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    count, rest = out.split(" ", 1)
    assert int(count) >= 20
    assert rest == "[] []"


TRAIN_SCRIPT = """
import sys
import gator_tpu_torch.train, gator_tpu_torch.losses
import gator_tpu_torch.nn.gat_trunk_train, gator_tpu_torch.nn.lbf_stack_train
from gator_tpu_torch.nn import cuda_lib
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton",
                              "gator_tpu")]
print(bad, sorted(cuda_lib._LOADED))
"""


def test_training_modules_import_no_jax_and_build_nothing():
    """The train package, the losses and the two training-kernel modules
    import neither JAX nor the JAX package, and load no kernel library."""
    out = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    assert out == "[] []"
