"""Shared set-up for the PyTorch port's parity tests (`tests/test_torch_*.py`):
seeded weights in the JAX package's parameter tree, carried into the port
through `state_dict_from_flax`, so both packages run the same numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowfast_vos_tpu.models.config import DetectionConfig, SlowFastConfig
from slowfast_vos_tpu.models.segmentation import SlowFastMaskRCNN as JaxModel
from slowfast_vos_tpu_torch.convert import state_dict_from_flax
from slowfast_vos_tpu_torch.models.segmentation import SlowFastMaskRCNN as PortModel
from torch_roi_cases import cuda_device  # noqa: F401 (fixture, re-exported)

# The tier-1 run has 6 workers on 8 cores.
torch.set_num_threads(2)


def noisy_variables(variables, seed: int = 0):
    """Every leaf of a flax tree (arrays or shape structs), BN statistics included, replaced by seeded
    numpy noise (so frozen BatchNorms are not identities): kernels
    ~ N(0, 1/fan_in), biases and means ~ N(0, 0.1^2), scales and variances
    ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, size=shape)
        else:  # bias, mean
            v = rng.normal(size=shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def make_models(slow=3, fast=3, cfg=None, seed=0):
    """(jax model, its noisy f32 variables, the port model with the same
    weights on the CPU in f32)."""
    cfg = cfg or DetectionConfig()
    sf = SlowFastConfig(slow=slow, fast=fast)
    jmodel = JaxModel(cfg=cfg, sf=sf, dtype=jnp.float32)
    dummy = jnp.zeros((max(fast, 2), 64, 64, 3), jnp.float32)
    # Only the tree's structure and shapes are needed: every leaf is redrawn.
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), dummy)
    variables = noisy_variables(shapes, seed)
    pmodel = PortModel(cfg, sf, torch.float32)
    pmodel.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, pmodel.eval()


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
