"""`state_dict_from_jax`: every flax leaf lands on a key of the port's
GATOR, `load_state_dict(strict=True)` consumes all of them, and the values
are exactly those of the JAX package's own torch-key export
(gator_tpu.convert.export_state_dict)."""
import jax
import numpy as np
import pytest
import torch

from gator_tpu.convert import export_state_dict
from gator_tpu.models import GatorSpec as JaxGatorSpec
from gator_tpu.models import init_gator
from gator_tpu_torch import assets as port_assets
from gator_tpu_torch.convert import state_dict_from_jax
from gator_tpu_torch.models import GATOR, GatorSpec


def jax_variables(init_fn, spec, seed):
    """`init_fn(spec, PRNGKey(seed))` (the JAX package's `init_gator` or
    `init_gat`) as a tree of numpy arrays. Compiled without XLA's backend
    optimisations: the init's random-number code otherwise takes ~20 s to
    compile on one CPU core, and it runs once."""
    key = jax.random.PRNGKey(seed)
    init = jax.jit(lambda k: init_fn(spec, k)).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree_util.tree_map(np.asarray, init(key))


@pytest.mark.parametrize("alpha", [False, True])
def test_state_dict_from_jax_loads_strict_and_exact(small_assets, alpha):
    jspec = JaxGatorSpec.from_assets(small_assets, embed_dim=128, depth=2,
                                     alpha=alpha)
    variables = jax_variables(init_gator, jspec, 3)
    state = state_dict_from_jax(variables)
    reference = export_state_dict(variables)

    bn_counters = {k for k in state if k.endswith("num_batches_tracked")}
    assert bn_counters == (set() if alpha
                           else {"pose2mesh.bias_norm.num_batches_tracked"})
    assert set(state) - bn_counters == set(reference)
    for key, val in reference.items():
        np.testing.assert_array_equal(state[key].numpy(), val, err_msg=key)

    passets = port_assets.build_assets("human36", data_dirs=[],
                                       synthetic_vertex_num=890, seed=0)
    model = GATOR(GatorSpec.from_assets(passets, embed_dim=128, depth=2,
                                        alpha=alpha))
    model.load_state_dict(state, strict=True)
    assert set(model.state_dict()) == set(state)
    for key, val in model.state_dict().items():
        assert torch.equal(val, state[key]), key
