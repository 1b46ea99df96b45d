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


def jax_draws(key, n, num_anchors, num_boxes):
    """The uniform draws `Trainer._loss_fn` makes from `key`: split into the
    RPN and sampling keys, each split per frame, each frame's key split
    into (positive, negative) draws (`train_step.py:236,252`,
    `rpn.py:273`, `matching.py:79-82,121-123`)."""
    key_rpn, key_sample = jax.random.split(key)
    out = {}
    for name, k, m in (("rpn", key_rpn, num_anchors), ("box", key_sample, num_boxes)):
        pairs = [jax.random.split(fk) for fk in jax.random.split(k, n)]
        out[f"{name}_pos"] = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kp, (m,))) for kp, _ in pairs]))
        out[f"{name}_neg"] = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kn, (m,))) for _, kn in pairs]))
    return out


# The driver tests' tiny set-up (tests/test_end_to_end.py): 60x100 frames,
# min 64 / max 128, SlowFast 1-3, 6-frame trees.
TINY_CFG = DetectionConfig(
    rpn_pre_nms_top_n_train=64,
    rpn_post_nms_top_n_train=32,
    rpn_pre_nms_top_n_test=64,
    rpn_post_nms_top_n_test=32,
    box_batch_size_per_image=32,
    mask_train_rois=8,
    detections_per_img=5,
    max_gt=3,
)
TINY_HW = (60, 100)
TINY_KW = dict(original_hw=TINY_HW, min_size=64, max_size=128, cfg=TINY_CFG)


def tiny_trees(tmp_path_factory):
    """A 2017 train tree (1 sequence, 6 frames, 2 objects) and a 2016 val
    tree (1 sequence, 6 frames, 1 object), written by the JAX package."""
    from slowfast_vos_tpu.data.synthetic import make_synthetic_davis

    train_root = str(tmp_path_factory.mktemp("train17"))
    eval_root = str(tmp_path_factory.mktemp("eval16"))
    make_synthetic_davis(train_root, num_sequences=1, frames=6, hw=TINY_HW, num_objects=2)
    make_synthetic_davis(eval_root, num_sequences=1, frames=6, hw=TINY_HW, num_objects=1, year="2016", subset="val", seed=7)
    return train_root, eval_root


def tiny_pipelines(slow=1, fast=3, seed=0, use_slow_fast=True):
    """(JAX pipeline, its noisy f32 variables, the port's CPU f32 pipeline,
    the same weights as a port state dict) at the tiny set-up."""
    from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
    from slowfast_vos_tpu_torch.models.pipeline import build_pipeline

    jpipe, jmodel = jax_build_pipeline(
        slow, fast, dtype=jnp.float32, backbone_batch=4, chunk=4, use_slow_fast=use_slow_fast, **TINY_KW
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((max(fast, 2), 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed)
    pipe, _ = build_pipeline(slow, fast, dtype=torch.float32, device="cpu", use_slow_fast=use_slow_fast, **TINY_KW)
    state_dict = state_dict_from_flax(variables)
    return jpipe, variables, pipe, state_dict


def logged(path_glob, tag):
    """The values a MetricsLogger JSON-lines file holds for `tag`, in order."""
    import glob
    import json

    (path,) = glob.glob(path_glob)
    return [r["value"] for r in map(json.loads, open(path)) if r["tag"] == tag]
