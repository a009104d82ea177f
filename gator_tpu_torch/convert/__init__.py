from .from_jax import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
