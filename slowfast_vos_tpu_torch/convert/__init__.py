"""Weights carried into the port: from the JAX package's parameter tree, and
from reference PyTorch checkpoints."""
from slowfast_vos_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: F401
from slowfast_vos_tpu_torch.convert.from_torchvision import load_init, load_reference_state_dict  # noqa: F401
