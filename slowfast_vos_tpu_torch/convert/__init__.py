"""Weights carried from the JAX package's parameter tree to the port."""
from slowfast_vos_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: F401
