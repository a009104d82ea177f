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
    assert int(count) >= 35
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


EVAL_SCRIPT = """
import sys
import gator_tpu_torch.cli.test, gator_tpu_torch.cli.common
import gator_tpu_torch.config, gator_tpu_torch.metrics, gator_tpu_torch.vis
import gator_tpu_torch.bodymodel.smpl, gator_tpu_torch.bodymodel.rotations
import gator_tpu_torch.data.base, gator_tpu_torch.data.pipeline
import gator_tpu_torch.data.gt_synth, gator_tpu_torch.data.synthetic
import gator_tpu_torch.train.evaluate, gator_tpu_torch.train.checkpoint
import gator_tpu_torch.nn.fused_attention
from gator_tpu_torch.nn import cuda_lib
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                              "triton", "gator_tpu")]
print(bad, sorted(cuda_lib._LOADED))
"""


def test_eval_modules_import_no_jax_and_build_nothing():
    """The eval path (CLI, session, config, body model, GT synthesis,
    datasets, pipeline, metrics, eval loop, checkpoints, K3's module)
    imports neither JAX nor the JAX package, and loads no kernel library."""
    out = subprocess.run([sys.executable, "-c", EVAL_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    assert out == "[] []"


TOOLS_SCRIPT = """
import sys
import gator_tpu_torch.tools.profile_serving
import gator_tpu_torch.tools.exp_mdr_ablate
import gator_tpu_torch.tools.profile_lbf
import gator_tpu_torch.tools.profile_attention
import gator_tpu_torch.tools.profile_trunk
import gator_tpu_torch.tools.trunk_phases
import gator_tpu_torch.nn.lbf_layer, gator_tpu_torch.nn.lbf_ablate
from gator_tpu_torch.nn import cuda_lib
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton", "gator_tpu")]
print(bad, sorted(cuda_lib._LOADED))
"""


def test_layer_tools_import_no_jax_and_build_nothing():
    """The serving-profile, LBF-profile, attention-profile, trunk-profile,
    trunk-phase and LBF-ablation tools and the K2-layer and T1 modules import neither JAX nor the JAX
    package (nor the JAX tools they replace), and load no kernel library."""
    out = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    assert out == "[] []"
