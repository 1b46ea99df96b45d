"""ResNet-50 + Feature Pyramid Network backbone.

Port of `slowfast_vos_tpu/models/resnet_fpn.py`, with torchvision's module
tree (`body.layer1.0.conv1`, `fpn.inner_blocks.0`, ...) so a reference
state dict loads as it is. Convolutions run on NCHW tensors in channels-last
memory; the public functions take and return NHWC views, the JAX package's
layout.

Two TPU rewrites of the JAX module are not carried over: the dilated-conv
form of the P2 combine (`resnet_fpn.py:258-275`) is the plain upsample, add
and smooth here (the two agree to f32 accumulation tolerance), and the
space-to-depth stem is later work.
"""
from __future__ import annotations

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


class ResNet50(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3)):
        super().__init__()
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

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.body = ResNet50()
        self.fpn = FPN()

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = nchw(images).to(self.dtype).contiguous(memory_format=torch.channels_last)
        return [nhwc(p) for p in self.fpn(self.body(x))]
