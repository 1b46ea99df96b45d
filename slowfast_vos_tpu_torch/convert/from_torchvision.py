"""Reference PyTorch checkpoints -> the port's model, in place.

The port's counterpart of the JAX package's `load_torch_checkpoint` and
`convert_state_dict` (`slowfast_vos_tpu/convert/torchvision_weights.py:28,95`)
and of `scripts/train.py::_load_init` (`:65-92`). The port's module tree
uses torchvision's names, so no layout changes; what the loader handles is
which keys a file holds:

* a bare Mask R-CNN state dict (torchvision `maskrcnn_resnet50_fpn`, the
  reference's `maskrcnn_model.pth`, or the port's own Mask R-CNN fine-tune);
* a full reference `SegmentationModel` state dict, whose Mask R-CNN keys
  carry the prefix `maskrcnn_model.` beside `slow_fast.*`;
* the port's own checkpoint file (`utils/checkpoint.py`), through its
  `"model"` entry.

Newer torchvision layouts that nest a conv one level deeper
(`inner_blocks.0.0.weight`, `rpn.head.conv.0.0.weight`,
`mask_fcn1.0.weight`) map onto the port's names as the JAX converter maps
them. `num_batches_tracked` counters are ignored. Every tensor of the model
that the file lacks keeps its current value: loading a Mask R-CNN file into
a SlowFast model leaves `slow_fast.*` at the seeded init, as the JAX loader
keeps a missing subtree at its init. A file key with no place in the model
is reported, not loaded; a shape mismatch raises.
"""
from __future__ import annotations

import os
import re

import torch

PREFIX = "maskrcnn_model."

# Newer torchvision key layouts -> the port's (the JAX converter's optional
# `(?:\.0)?` / `(?:\.0\.0)?` groups, `torchvision_weights.py:176-229`).
_LAYOUTS = (
    (re.compile(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d)\.0\."), r"\1."),
    (re.compile(r"^(rpn\.head\.(?:conv|cls_logits|bbox_pred))\.0\.0\."), r"\1."),
    (re.compile(r"^(roi_heads\.mask_head\.mask_fcn\d)\.0\."), r"\1."),
)


def load_reference_state_dict(path: str) -> dict:
    """The object a `.pth` file holds, tensors on the CPU
    (`weights_only=True`); a module's state dict where it holds one."""
    sd = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def _port_name(key: str) -> str:
    if key.startswith(PREFIX):
        key = key[len(PREFIX):]
    for pattern, repl in _LAYOUTS:
        key = pattern.sub(repl, key)
    return key


def load_init(path: str, model: torch.nn.Module) -> dict:
    """Copy every tensor of the file at `path` that has a place in `model`
    into it, in place. Returns the report {converted: the number of tensors
    copied, unused_source_keys: file keys with no place in the model,
    untouched: model keys the file left at their current values}; no list
    names a `num_batches_tracked` counter. Raises ValueError, and loads
    nothing, where a file tensor's shape differs from the model's."""
    sd = load_reference_state_dict(path)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a state dict")
    if isinstance(sd.get("model"), dict):  # the port's own checkpoint file
        sd = sd["model"]
    target = model.state_dict()
    found, keys, unused = {}, {}, []
    for key, value in sd.items():
        if "num_batches_tracked" in key:
            continue
        name = _port_name(key)
        if name not in target or not torch.is_tensor(value):
            unused.append(key)
            continue
        found[name], keys[name] = value, key
    for name, value in found.items():
        if tuple(value.shape) != tuple(target[name].shape):
            raise ValueError(f"{path}: {keys[name]} has shape {tuple(value.shape)}, the model's {name} {tuple(target[name].shape)}")
    with torch.no_grad():  # only once every shape is known to fit
        for name, value in found.items():
            target[name].copy_(value)
    untouched = [k for k in target if k not in found and "num_batches_tracked" not in k]
    return {"converted": len(found), "unused_source_keys": unused, "untouched": untouched}
