"""Seeded random weights of ViTDet-B + SlowFast, made by the benchmark on the
device.

`weights.py`'s draws over the ViTDet reference's module tree
(`reference/vitdet.py`, whose names are the port's): in one normal and one
uniform call of a device generator seeded from the run's seed, every
convolution and linear weight N(0, 1/fan_in); every bias, BatchNorm shift
and running mean N(0, SHIFT^2); every BatchNorm and LayerNorm scale U(0.8,
1.2), every running variance U(0.8, 1.25). SlowFast and the predictors
draw as `weights.py` draws them.

Two draws are ViTDet's own, in the normal call: the position embedding
N(0, POS^2) and the relative-position tables N(0, REL^2). A table of
REL = 0.1 gives each term q . R a spread of about 0.8 against unit logits,
and POS = 0.5 moves each token by half a unit: dropping either term, or
resizing the embedding another way, changes what the program computes.
"""
from __future__ import annotations

import torch
from torch import nn

from vosbench.reference.model import Detection
from vosbench.reference.vitdet import Model, Widths
from vosbench.weights import SCALE, SHIFT, VARIANCE

POS = 0.5
REL = 0.1


def make_state(slow: int, fast: int, detection: dict, seed: int, device, widths: Widths = Widths()) -> dict:
    with torch.device("meta"):
        skeleton = Model(slow, fast, Detection(**detection), widths=widths)
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
        elif name.endswith("pos_embed"):
            normal.append((name, POS, 0.0))
        elif name.endswith(("rel_pos_h", "rel_pos_w")):
            normal.append((name, REL, 0.0))
        elif not t.is_floating_point():
            zeros.append(name)  # num_batches_tracked
        elif name.endswith("running_var"):
            uniform.append((name, VARIANCE[1] - VARIANCE[0], VARIANCE[0]))
        elif name.endswith(".weight"):
            uniform.append((name, SCALE[1] - SCALE[0], SCALE[0]))
        else:
            normal.append((name, SHIFT, 0.0))  # biases, norm shifts, running means
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
