"""Importing gator_tpu_torch and each of its modules pulls in neither JAX,
nor Triton, nor the JAX package, and builds no kernel and no native
library (checked in a fresh interpreter, since this test process has JAX
loaded)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import os, pkgutil, sys
lib = os.path.join("build", "native", "libgator_precompute.so")
def stamp():
    return os.path.getmtime(lib) if os.path.exists(lib) else None
before = stamp()
import gator_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gator_tpu_torch.__path__,
                                               "gator_tpu_torch.")]
for name in names:
    __import__(name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton",
                              "gator_tpu", "cv2", "matplotlib")]
from gator_tpu_torch.nn import cuda_lib
from gator_tpu_torch.assets import native
assert native.BUILD_DIR == os.path.abspath(os.path.dirname(lib))
print(len(names), bad, sorted(cuda_lib._LOADED), native._LOADED,
      stamp() == before)
"""


def test_import_pulls_in_no_jax_and_no_triton():
    """Every module of the port (the demo's and the surface's too) imports;
    none pulls in JAX, optax, Triton, the JAX package, or the optional
    cv2 and matplotlib, which the drawing functions import when they
    draw; no CUDA kernel is built and `assets.native` neither builds nor
    loads its library."""
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    count, rest = out.split(" ", 1)
    # 84 since the demo, camera, vis, smoothing, profiling, ops,
    # coarsening, native, MANO and 6D-rotation modules
    assert int(count) >= 84
    assert rest == "[] [] {} True"


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
import gator_tpu_torch.data.h36m, gator_tpu_torch.data.pw3d
import gator_tpu_torch.data.coco_ds, gator_tpu_torch.data.muco
import gator_tpu_torch.data.amass, gator_tpu_torch.data.noise
import gator_tpu_torch.data.coords, gator_tpu_torch.data.augment
import gator_tpu_torch.data.processing, gator_tpu_torch.cli.serve
from gator_tpu_torch.cli.common import build_datasets
import gator_tpu_torch.train.evaluate, gator_tpu_torch.train.checkpoint
import gator_tpu_torch.nn.fused_attention
from gator_tpu_torch.nn import cuda_lib
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                              "triton", "gator_tpu")]
print(bad, sorted(cuda_lib._LOADED))
"""


def test_eval_modules_import_no_jax_and_build_nothing():
    """The eval path (CLI, session and `build_datasets`, config, body
    model, GT synthesis, the five dataset readers, the coordinate,
    augmentation, noise and preprocessing modules, pipeline, metrics, eval
    loop, checkpoints, K3's module) and the serve CLI import neither JAX
    nor the JAX package, and load no kernel library."""
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


TRAIN_CLI_SCRIPT = """
import sys
import gator_tpu_torch.cli.train, gator_tpu_torch.cli.common
import gator_tpu_torch.tools.run_convergence_cli
import gator_tpu_torch.train.state, gator_tpu_torch.train.checkpoint
import gator_tpu_torch.train.schedule, gator_tpu_torch.config
import gator_tpu_torch.vis
from gator_tpu_torch.nn import cuda_lib
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                              "triton", "gator_tpu", "matplotlib")]
print(bad, sorted(cuda_lib._LOADED))
"""


def test_train_cli_and_convergence_tool_import_no_jax():
    """The train CLI, the port's convergence tool and the modules they
    added to (state, checkpoints, schedules, session, config, vis) import
    neither JAX nor the JAX package (nor matplotlib, which the loss plot
    imports when it draws), and load no kernel library."""
    out = subprocess.run([sys.executable, "-c", TRAIN_CLI_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")[-2]
    assert out == "[] []"
