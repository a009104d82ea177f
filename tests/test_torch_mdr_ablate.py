"""T1, the LBF-layer ablations: every mode of the port's `run_layers` (its
plain version `run_layers_ref` on the CPU) against the JAX tool's
`run_layers` (tools/exp_mdr_ablate.py:199), with the same numpy-made
weights and inputs on both sides; and the port's refusals. The CUDA kernels
are held against `run_layers_ref` in test_torch_layer_kernels_cuda.py.

The JAX tool's pallas_call passes no `interpret` flag, so here the tool's
module gets a `pl` whose `pallas_call` interprets; its import turns on
XLA's persistent compile cache (`:19-21`), which `JAX_CACHE_DIR` keeps in
the test's tmp_path and the fixture turns back off. The JAX side is
compiled with every bf16 cast kept (`exact`, test_torch_lbf_layer.py).

B=4, group 2, J=17, one layer at Nv=431 (432 for `nosoftmax`, where the
TPU kernel adds no pad key row), and `full` over three layers. Bars as in
test_torch_lbf_layer.py (f32 max abs 1e-5; bf16 at least 95 % of the
elements bit-equal, mean abs 5e-4 and max abs 2^-5), with two changes in
bf16 for the modes that run the self-attention:
  * at least 90 % of the elements bit-equal, not 95 %. There a bf16
    rounding that flips anywhere in a sample's k2 or v2 rows (an f32 sum
    taken in another order, the exact erf against the TPU kernel's
    polynomial) reaches every output row of the sample, so the output's
    bits move with the f32 sum order alone. The port's own plain version
    with its products summed exactly (in f64, rounded once) has only
    95.6 % (`full`), 94.5 % (`nogelu`) and 93.8 % (`bf16gelu`) of its
    elements bit-equal to itself (the witness test below), and 93.6 %,
    92.6 % and 92.0 % to JAX. The row-local modes (lnonly, mlponly,
    noself) keep the 95 % bar;
  * `bf16smax` is held to a mean abs of 2e-3 only (XLA and the port sum
    its bf16 exponentials in other orders); its stats are in the message.
Three layers in bf16 are held layer by layer, each on the JAX input of
that layer, for the reason test_torch_lbf_layer.py gives.
"""
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_lbf_layer import (DTYPES, assert_close, exact,
                                  random_layer_params)
from gator_tpu_torch.convert import layer_weights_from_jax
from gator_tpu_torch.nn import MODES, run_layers, run_layers_ref
from gator_tpu_torch.nn.lbf_ablate import ROW_MODES

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "exp_mdr_ablate.py")


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """tools/exp_mdr_ablate.py with its pallas_call in interpret mode."""
    cache = str(tmp_path_factory.mktemp("jax_cache"))
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_CACHE_DIR", cache)
    try:
        spec = importlib.util.spec_from_file_location("exp_mdr_ablate", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
        # the import turned the cache on for the whole process
        for k, v in before.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def _case(nv, n_layers, seed):
    rng = np.random.default_rng(seed)
    params = [random_layer_params(rng) for _ in range(n_layers)]
    verts = rng.normal(size=(4, nv, 64)).astype(np.float32)
    joints = rng.normal(size=(4, 17, 64)).astype(np.float32)
    return params, verts, joints


def _compare(jax_tool, mode, nv, n_layers, dtype):
    tdt, jdt = DTYPES[dtype]
    params, verts, joints = _case(nv, n_layers, MODES.index(mode))
    jparams = [{k: jnp.asarray(v, jdt) for k, v in p.items()}
               for p in params]
    layers = [layer_weights_from_jax(p, tdt, "cpu") for p in params]
    tj = torch.from_numpy(joints).to(tdt)
    bars = {"min_equal": 0.95 if mode in ROW_MODES else 0.9}
    if mode == "bf16smax":
        bars = {"min_equal": 0.0, "mean_bar": 2e-3}
    # f32: the whole stack at once; bf16: layer by layer on JAX's input
    steps = [slice(0, n_layers)] if dtype == "float32" else [
        slice(i, i + 1) for i in range(n_layers)]
    jv = jnp.asarray(verts, jdt)
    for step in steps:
        tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(tdt)
        jv = exact(lambda v, j, lps: jax_tool.run_layers(v, j, lps, 2, 2,
                                                         mode),
                   jv, jnp.asarray(joints, jdt), jparams[step])
        got = run_layers(tv, tj, layers[step], 2, 2, mode)
        assert got.dtype == tdt and got.shape == (4, nv, 64)
        assert torch.equal(got, run_layers_ref(tv, tj, layers[step], 2, 2,
                                               mode))
        what = f"{mode} {dtype} layers {step.start}:{step.stop}"
        stats = assert_close(got, jv, dtype, what, **bars)
        print(f"{what}: bit-equal {stats[0]:.4f}, "
              f"mean abs {stats[1]:.2e}, max abs {stats[2]:.2e}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_run_layers_matches_jax_tool(jax_tool, mode, dtype):
    _compare(jax_tool, mode, 432 if mode == "nosoftmax" else 431, 1, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_run_layers_full_three_layers_matches_jax_tool(jax_tool, dtype):
    _compare(jax_tool, "full", 431, 3, dtype)


@pytest.mark.parametrize("mode", ["full", "nogelu", "bf16gelu"])
def test_bf16_output_moves_with_the_f32_sum_order(mode, monkeypatch):
    """The witness for the 90 % bar: the same plain version, with only the
    order of its f32 sums changed (each product summed in f64 and rounded
    to f32 once), moves more than 3 % of its bf16 output elements on the
    inputs that test_run_layers_matches_jax_tool uses. Both print their
    fractions (`pytest -s`)."""
    params, verts, joints = _case(431, 1, MODES.index(mode))
    layers = [layer_weights_from_jax(params[0], torch.bfloat16, "cpu")]
    v, j = (torch.from_numpy(a).bfloat16() for a in (verts, joints))
    f32_sums = run_layers_ref(v, j, layers, 2, 2, mode)
    matmul = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        lambda a, b: matmul(a.double(), b.double()).float())
    exact_sums = run_layers_ref(v, j, layers, 2, 2, mode)
    monkeypatch.undo()
    frac = (f32_sums == exact_sums).float().mean().item()
    print(f"{mode} bf16, f32 sums against exact sums: bit-equal {frac:.4f}")
    assert 0.9 <= frac < 0.97, frac


def test_run_layers_refuses_unknown_mode_and_ragged_group():
    params, verts, joints = _case(40, 1, 0)
    layers = [layer_weights_from_jax(params[0], torch.float32, "cpu")]
    v, j = torch.from_numpy(verts), torch.from_numpy(joints)
    with pytest.raises(ValueError, match="unknown mode"):
        run_layers(v, j, layers, 2, 2, "nolayer")
    with pytest.raises(ValueError, match="not a multiple"):
        run_layers(v, j, layers, 2, 3, "full")
    with pytest.raises(ValueError, match="not a multiple"):
        run_layers_ref(v, j, layers, 2, 8, "full")
    assert set(ROW_MODES) < set(MODES) and len(MODES) == 13


def test_exp_mdr_ablate_refuses_unknown_modes_and_a_missing_card():
    from gator_tpu_torch.tools import exp_mdr_ablate
    with pytest.raises(ValueError, match="unknown modes"):
        exp_mdr_ablate.main(["full", "nolayer"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_mdr_ablate.main([])
