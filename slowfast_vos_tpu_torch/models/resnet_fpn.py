"""ResNet-50 + Feature Pyramid Network backbone.

Port of `slowfast_vos_tpu/models/resnet_fpn.py`, with torchvision's module
tree (`body.layer1.0.conv1`, `fpn.inner_blocks.0`, ...) so a reference
state dict loads as it is. Convolutions run on NCHW tensors in channels-last
memory; the public functions take and return NHWC views, the JAX package's
layout.

The stem is torchvision's 7x7/stride-2 conv1.

Every convolution of the body ends in one pass of K8
(`ops/conv_epilogue.py`): each frozen BatchNorm's scale is folded into its
convolution's weights in float32 before their cast to the compute dtype,
and its shift, the residual and the ReLU are that pass's
(`conv_bn`); the FPN's convolutions add their bias in it (`conv_bias`).
The fold is taken in each forward from the buffers as they stand
(`layers.py::fold_frozen_batch_norms`, once for the whole body), so the
state dict is torchvision's and a buffer loaded in place is read at the
next call, CUDA graph replays included.

The dilated-conv form of the P2 combine (`resnet_fpn.py:258-275`), a TPU
rewrite, is not carried over: it is the plain upsample, add and smooth here
(the two agree to f32 accumulation tolerance).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d, fold_frozen_batch_norms, nchw, nhwc
from slowfast_vos_tpu_torch.ops.conv_epilogue import conv_epilogue

FPN_STRIDES = (4, 8, 16, 32, 64)


def conv_bn(x: torch.Tensor, conv: Conv2d, bn: FrozenBatchNorm2d, folds: dict,
            residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """act(bn(conv(x)) (+ residual)) as one convolution and one K8 pass: bn's
    scale (from `folds`, `fold_frozen_batch_norms` of a module that holds
    bn) multiplies conv's weights in float32 before their cast to x's dtype,
    and its shift is the epilogue's bias."""
    scale, shift = folds[bn]
    w = (conv.weight * scale[:, None, None, None]).to(x.dtype)
    return conv_epilogue(conv._conv_forward(x, w, None), shift, residual, relu)


def conv_bias(x: torch.Tensor, conv: Conv2d) -> torch.Tensor:
    """conv(x) with conv's bias added by K8, not by the convolution's own
    broadcast add."""
    return conv_epilogue(conv._conv_forward(x, conv.weight.to(x.dtype), None), conv.bias)


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

    def forward(self, x: torch.Tensor, folds: dict) -> torch.Tensor:
        """`folds`: `fold_frozen_batch_norms` of a module that holds this
        block (the whole body's, from `ResNet50.forward`)."""
        shortcut = x if self.downsample is None else conv_bn(x, *self.downsample, folds)
        y = conv_bn(x, self.conv1, self.bn1, folds, relu=True)
        y = conv_bn(y, self.conv2, self.bn2, folds, relu=True)
        return conv_bn(y, self.conv3, self.bn3, folds, residual=shortcut, relu=True)


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
        folds = fold_frozen_batch_norms(self)
        x = conv_bn(x, self.conv1, self.bn1, folds, relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, folds)
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
        last = conv_bias(inputs[-1], self.inner_blocks[-1])
        outs = [conv_bias(last, self.layer_blocks[-1])]
        for i in range(len(inputs) - 2, -1, -1):
            lat = conv_bias(inputs[i], self.inner_blocks[i])
            h, w = lat.shape[-2:]
            # Nearest 2x then crop: the JAX package's repeat-and-slice.
            up = F.interpolate(last, scale_factor=2, mode="nearest")[..., :h, :w]
            last = lat + up
            outs.insert(0, conv_bias(last, self.layer_blocks[i]))
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
