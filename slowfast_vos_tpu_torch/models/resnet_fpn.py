"""ResNet-50 + Feature Pyramid Network backbone.

Port of `slowfast_vos_tpu/models/resnet_fpn.py`, with torchvision's module
tree (`body.layer1.0.conv1`, `fpn.inner_blocks.0`, ...) so a reference
state dict loads as it is. Convolutions run on NCHW tensors in channels-last
memory; the public functions take and return NHWC views, the JAX package's
layout.

The stem is torchvision's 7x7/stride-2 conv1 by default. `s2d_stem=True`
builds the JAX package's space-to-depth stem instead (`resnet_fpn.py:142-152`):
space-to-depth(2) of the input, then a 4x4/stride-1 conv1 ([64, 12, 4, 4])
over it, padded (2, 1) on each axis. The two compute the same function under
the exact kernel remaps `stem_kernel_to_s2d` / `stem_kernel_from_s2d` (numpy,
HWIO, as in JAX; `stem_weight_to_s2d` / `stem_weight_from_s2d` for the
port's OIHW weights), so a checkpoint of either stem loads into a model of
either (`utils/checkpoint.py::migrate_state_dict`).

The dilated-conv form of the P2 combine (`resnet_fpn.py:258-275`), a TPU
rewrite, is not carried over: it is the plain upsample, add and smooth here
(the two agree to f32 accumulation tolerance).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d, nchw, nhwc

FPN_STRIDES = (4, 8, 16, 32, 64)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4), projection shortcut on a stage's first block."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(features)
        self.conv3 = Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(features * 4)
        self.downsample = None
        if stride != 1 or cin != features * 4:
            self.downsample = nn.Sequential(
                Conv2d(cin, features * 4, 1, stride, bias=False),
                FrozenBatchNorm2d(features * 4),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


def stem_kernel_to_s2d(w7: np.ndarray) -> np.ndarray:
    """The standard 7x7/s2 stem kernel [7, 7, 3, 64] (HWIO) as the equivalent
    4x4/s1 kernel [4, 4, 12, 64] over the space-to-depth(2) input (JAX
    `resnet_fpn.py:104-125`).

    out[i, j] = sum_e w[e + 3] x[2i + e] = sum_{k, p} K[k, (p, ., c)] y[i + k - 2, .]
    with e = 2(k - 2) + p; the tap e = -4 (k = 0, p = 0) is zero."""
    kh, kw, c, o = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"a 7x7 stem kernel is [7, 7, C, O], not {list(w7.shape)}")
    out = np.zeros((4, 4, 4 * c, o), w7.dtype)
    for ki in range(4):
        for pi in range(2):
            ei = 2 * (ki - 2) + pi
            if not -3 <= ei <= 3:
                continue
            for kj in range(4):
                for pj in range(2):
                    ej = 2 * (kj - 2) + pj
                    if not -3 <= ej <= 3:
                        continue
                    out[ki, kj, (pi * 2 + pj) * c : (pi * 2 + pj + 1) * c] = w7[ei + 3, ej + 3]
    return out


def stem_kernel_from_s2d(w44: np.ndarray) -> np.ndarray:
    """Inverse of `stem_kernel_to_s2d`: [4, 4, 12, 64] -> [7, 7, 3, 64] (JAX
    `resnet_fpn.py:57-94`). Each 7x7 tap (ei, ej) lives at exactly one
    (ki, pi, kj, pj) with e = 2(k - 2) + p. The (k = 0, p = 0) slots sit at
    tap e = -4, outside the 7x7 field: zero in a remapped kernel, but a
    fine-tuned s2d checkpoint may carry signal there, which this map drops
    with a warning."""
    if tuple(w44.shape[:2]) != (4, 4):
        raise ValueError(f"an s2d stem kernel is [4, 4, 4C, O], not {list(w44.shape)}")
    c = w44.shape[2] // 4
    w44 = np.asarray(w44)
    # Slots with ei = -4 (ki = 0, pi = 0: channel groups 0, 1) or ej = -4
    # (kj = 0, pj = 0: channel groups 0, 2) fall outside the 7x7 kernel.
    dropped = float(
        np.abs(w44[0, :, : 2 * c]).sum() + np.abs(w44[:, 0, 0 * c : 1 * c]).sum() + np.abs(w44[:, 0, 2 * c : 3 * c]).sum()
    )
    if dropped > 1e-6 * max(1.0, float(np.abs(w44).sum())):
        warnings.warn(
            f"stem_kernel_from_s2d: dropping non-zero e=-4 taps (|sum|={dropped:.3e}) "
            "from a fine-tuned s2d stem; the migration is lossy for this checkpoint.",
            stacklevel=2,
        )
    out = np.zeros((7, 7, c, w44.shape[3]), w44.dtype)
    for ei in range(-3, 4):
        pi = ei % 2
        ki = (ei - pi) // 2 + 2
        for ej in range(-3, 4):
            pj = ej % 2
            kj = (ej - pj) // 2 + 2
            out[ei + 3, ej + 3] = w44[ki, kj, (pi * 2 + pj) * c : (pi * 2 + pj + 1) * c]
    return out


def _remap_oihw(remap, w: torch.Tensor) -> torch.Tensor:
    hwio = remap(w.detach().cpu().permute(2, 3, 1, 0).numpy())
    return torch.from_numpy(hwio).permute(3, 2, 0, 1).contiguous().to(w.device)


def stem_weight_to_s2d(w: torch.Tensor) -> torch.Tensor:
    """`stem_kernel_to_s2d` on the port's OIHW conv1 weight: [64, 3, 7, 7] ->
    [64, 12, 4, 4]."""
    return _remap_oihw(stem_kernel_to_s2d, w)


def stem_weight_from_s2d(w: torch.Tensor) -> torch.Tensor:
    """`stem_kernel_from_s2d` on the port's OIHW conv1 weight: [64, 12, 4, 4]
    -> [64, 3, 7, 7]."""
    return _remap_oihw(stem_kernel_from_s2d, w)


def space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/f, W/f, f*f*C], channel order (p, q, c): input
    channel (p * f + q) * C + c holds pixel (f*i + p, f*j + q), as JAX's
    `space_to_depth` on NHWC."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // factor, w // factor, factor * factor * c)


class ResNet50(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3), s2d_stem: bool = False):
        super().__init__()
        self.s2d_stem = s2d_stem
        if s2d_stem:
            # Padded explicitly in `forward`: (2, 1) is not a Conv2d padding.
            self.conv1 = Conv2d(12, 64, 4, 1, bias=False)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, features = 64, 64
        for stage, nblocks in enumerate(stage_sizes):
            blocks = []
            for i in range(nblocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(cin, features, stride))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW images -> [C2 (/4), C3 (/8), C4 (/16), C5 (/32)]."""
        if self.s2d_stem:
            x = F.pad(nchw(space_to_depth(nhwc(x), 2)), (2, 1, 2, 1))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Lateral 1x1 + top-down nearest upsample + 3x3 smoothing, 256 channels,
    plus the stride-64 'pool' level (max_pool(1, stride 2) of P5) that feeds
    only the RPN."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList([Conv2d(c, out_channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels]
        )

    def forward(self, inputs: list[torch.Tensor]) -> list[torch.Tensor]:
        last = self.inner_blocks[-1](inputs[-1])
        outs = [self.layer_blocks[-1](last)]
        for i in range(len(inputs) - 2, -1, -1):
            lat = self.inner_blocks[i](inputs[i])
            h, w = lat.shape[-2:]
            # Nearest 2x then crop: the JAX package's repeat-and-slice.
            up = F.interpolate(last, scale_factor=2, mode="nearest")[..., :h, :w]
            last = lat + up
            outs.insert(0, self.layer_blocks[i](last))
        outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs  # P2, P3, P4, P5, P6 ('pool')


class ResNet50FPN(nn.Module):
    """Full backbone: images [N, H, W, 3] -> 5 NHWC FPN maps (strides 4..64)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, s2d_stem: bool = False):
        super().__init__()
        self.dtype = dtype
        self.body = ResNet50(s2d_stem=s2d_stem)
        self.fpn = FPN()

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = nchw(images).to(self.dtype).contiguous(memory_format=torch.channels_last)
        return [nhwc(p) for p in self.fpn(self.body(x))]
