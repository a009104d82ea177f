from .from_jax import layer_weights_from_jax, state_dict_from_jax

__all__ = ["layer_weights_from_jax", "state_dict_from_jax"]
