"""Seeded random weights, made by the benchmark on the device.

The state dict follows the reference's module tree (`reference/model.py`),
whose names are the port's, so the same tensors load into both. It is drawn
in two calls of a device generator seeded from the run's seed:

* normal: every convolution and linear weight N(0, 1/fan_in) (lecun
  normal, untruncated, as the port's own initializer); every other bias,
  BatchNorm shift and running mean N(0, SHIFT^2);
* uniform: every BatchNorm scale U(0.8, 1.2) and running variance
  U(0.8, 1.25), so that E[scale^2 / variance] is about 1 and activations
  keep their size through the backbone.

Wider draws (scales U(0.5, 1.5), shifts N(0, 0.1^2)) push the mask head's
logits to one side, so that most masks cover all of a box or none of it and
the numbers that judge them find little to judge.

Every channel is scaled and shifted its own way, in the frozen BatchNorms,
SlowFast's BatchNorms (affine terms and running statistics) and the
biases: a fold that drops a term, or takes another channel's, changes what
the program computes.
"""
from __future__ import annotations

import torch
from torch import nn

from vosbench.reference.model import Detection, Model

SHIFT = 0.02
SCALE = (0.8, 1.2)
VARIANCE = (0.8, 1.25)


def make_state(slow: int, fast: int, detection: dict, seed: int, device) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = Model(slow, fast, Detection(**detection))
    weighted = [m for m in skeleton.modules() if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.ConvTranspose2d))]
    fan_in = {}
    for m in weighted:
        w = m.weight
        cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
        fan_in[id(w)] = cin * w[0, 0].numel()
    params = dict(skeleton.named_parameters())
    tensors = skeleton.state_dict(keep_vars=True)
    normal, uniform, zeros = [], [], []
    for name, t in tensors.items():
        p = params.get(name)
        if p is not None and id(p) in fan_in:
            normal.append((name, fan_in[id(p)] ** -0.5, 0.0))
        elif not t.is_floating_point():
            zeros.append(name)  # num_batches_tracked
        elif name.endswith("running_var"):
            uniform.append((name, VARIANCE[1] - VARIANCE[0], VARIANCE[0]))
        elif name.endswith(".weight"):
            uniform.append((name, SCALE[1] - SCALE[0], SCALE[0]))
        else:
            normal.append((name, SHIFT, 0.0))  # biases, BatchNorm shifts, running means
    generator = torch.Generator(device=device).manual_seed(seed)
    state = {name: torch.zeros(tensors[name].shape, dtype=tensors[name].dtype, device=device) for name in zeros}
    for draw, group in ((torch.randn, normal), (torch.rand, uniform)):
        flat = draw(sum(tensors[name].numel() for name, _, _ in group), generator=generator, device=device)
        offset = 0
        for name, scale, base in group:
            n = tensors[name].numel()
            state[name] = flat[offset : offset + n].view(tensors[name].shape) * scale + base
            offset += n
    return {name: state[name] for name in tensors}
