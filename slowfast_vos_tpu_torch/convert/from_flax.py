"""The JAX package's parameter tree -> the port's torchvision-named state dict.

The exact inverse of `slowfast_vos_tpu/convert/torchvision_weights.py::
convert_state_dict` (line 95), working on plain numpy arrays:

* HWIO conv [kh, kw, I, O]             -> OIHW [O, I, kh, kw]
* conv3d [kt, kh, kw, I, O]            -> [O, I, kt, kh, kw]
* dense [in, out]                      -> [out, in]
* fc6 over an HWC flatten              -> fc6 over torch's CHW flatten
* spatially flipped [kh, kw, I, O] deconv -> ConvTranspose2d [I, O, kh, kw]
* FrozenBN scale/bias/mean/var         -> weight/bias/running_mean/running_var
* SlowFast BN (`batch_stats` mean/var) -> BatchNorm3d running stats

The SlowFast name map is the port's own copy of `_SF_MAP`.
"""
from __future__ import annotations

import numpy as np
import torch

# reference name -> JAX module name (SlowFast, reference model.py:47-67)
SF_MAP = {
    "fast_conv1": "fast1_conv", "bn_f1": "fast1_bn",
    "slow_conv1": "slow1_conv", "bn_s1": "slow1_bn",
    "fast_conv2": "fast2_conv", "bn_f2": "fast2_bn",
    "slow_conv2": "slow2_conv", "bn_s2": "slow2_bn",
    "fast_conv3": "fast3_conv", "bn_f3": "fast3_bn",
    "slow_conv3": "slow3_conv", "bn_s3": "slow3_bn",
    "conv_f2s1": "f2s1_conv", "bn_f2s1": "f2s1_bn",
    "conv_f2s2": "f2s2_conv", "bn_f2s2": "f2s2_bn",
}

_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))


def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))


def _conv3d(k):
    return np.transpose(k, (4, 3, 0, 1, 2))


def _fc6(k, pooled=7):
    """[HWC in, out] -> [out, CHW in]."""
    out = k.shape[1]
    c = k.shape[0] // (pooled * pooled)
    return k.T.reshape(out, pooled, pooled, c).transpose(0, 3, 1, 2).reshape(out, -1)


def _deconv(k):
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """`{"params": ..., "batch_stats": ...}` of `SlowFastMaskRCNN` (any
    mapping of numpy-convertible leaves) -> the port's state dict, float32,
    loadable with `load_state_dict(strict=True)`."""
    p = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, np.ndarray] = {}

    def bn(prefix, node):
        for tname, fname in _BN:
            sd[f"{prefix}.{tname}"] = node[fname]

    body = p["backbone"]["body"]
    sd["backbone.body.conv1.weight"] = _conv(body["conv1"]["kernel"])
    bn("backbone.body.bn1", body["bn1"])
    for name, block in body.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_")
        pre = f"backbone.body.layer{stage}.{idx}"
        for i in "123":
            sd[f"{pre}.conv{i}.weight"] = _conv(block[f"conv{i}"]["kernel"])
            bn(f"{pre}.bn{i}", block[f"bn{i}"])
        if "downsample_conv" in block:
            sd[f"{pre}.downsample.0.weight"] = _conv(block["downsample_conv"]["kernel"])
            bn(f"{pre}.downsample.1", block["downsample_bn"])

    fpn = p["backbone"]["fpn"]
    for i in range(4):
        for src, dst in ((f"inner_{i}", "inner_blocks"), (f"layer_{i}", "layer_blocks")):
            sd[f"backbone.fpn.{dst}.{i}.weight"] = _conv(fpn[src]["kernel"])
            sd[f"backbone.fpn.{dst}.{i}.bias"] = fpn[src]["bias"]

    for mod in ("conv", "cls_logits", "bbox_pred"):
        sd[f"rpn.head.{mod}.weight"] = _conv(p["rpn"][mod]["kernel"])
        sd[f"rpn.head.{mod}.bias"] = p["rpn"][mod]["bias"]

    box = p["box_head"]
    sd["roi_heads.box_head.fc6.weight"] = _fc6(np.asarray(box["fc6"]["kernel"]))
    sd["roi_heads.box_head.fc6.bias"] = box["fc6"]["bias"]
    sd["roi_heads.box_head.fc7.weight"] = np.asarray(box["fc7"]["kernel"]).T
    sd["roi_heads.box_head.fc7.bias"] = box["fc7"]["bias"]
    for mod in ("cls_score", "bbox_pred"):
        sd[f"roi_heads.box_predictor.{mod}.weight"] = np.asarray(box[mod]["kernel"]).T
        sd[f"roi_heads.box_predictor.{mod}.bias"] = box[mod]["bias"]

    mask = p["mask_head"]
    for i in "1234":
        sd[f"roi_heads.mask_head.mask_fcn{i}.weight"] = _conv(mask[f"mask_fcn{i}"]["kernel"])
        sd[f"roi_heads.mask_head.mask_fcn{i}.bias"] = mask[f"mask_fcn{i}"]["bias"]
    sd["roi_heads.mask_predictor.conv5_mask.weight"] = _deconv(np.asarray(mask["conv5_mask"]["kernel"]))
    sd["roi_heads.mask_predictor.conv5_mask.bias"] = mask["conv5_mask"]["bias"]
    sd["roi_heads.mask_predictor.mask_fcn_logits.weight"] = _conv(mask["mask_fcn_logits"]["kernel"])
    sd["roi_heads.mask_predictor.mask_fcn_logits.bias"] = mask["mask_fcn_logits"]["bias"]

    if "slow_fast" in p:  # absent in the plain Mask R-CNN (use_slow_fast=False)
        sd.update(slow_fast_state_dict(p["slow_fast"], stats["slow_fast"], prefix="slow_fast."))
    return _to_torch(sd)


def slow_fast_state_dict(params, batch_stats, prefix: str = "") -> dict[str, torch.Tensor]:
    """The `SlowFastTemporal` subtree (params and batch_stats) -> reference
    names (`fast_conv1.weight`, `bn_f1.running_mean`, ...) under `prefix`."""
    sd: dict[str, np.ndarray] = {}
    for ref, jax_name in SF_MAP.items():
        pre = f"{prefix}{ref}"
        if jax_name.endswith("_bn"):
            sd[f"{pre}.weight"] = params[jax_name]["scale"]
            sd[f"{pre}.bias"] = params[jax_name]["bias"]
            sd[f"{pre}.running_mean"] = batch_stats[jax_name]["mean"]
            sd[f"{pre}.running_var"] = batch_stats[jax_name]["var"]
            sd[f"{pre}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            sd[f"{pre}.weight"] = _conv3d(params[jax_name]["kernel"])
            if "bias" in params[jax_name]:
                sd[f"{pre}.bias"] = params[jax_name]["bias"]
    return _to_torch(sd)


def _to_torch(sd) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(np.ascontiguousarray(v if v.dtype == np.int64 else v.astype(np.float32)))
    return out
