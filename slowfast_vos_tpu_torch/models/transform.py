"""Image preprocessing: normalize, resize, pad to a static canvas.

Port of `slowfast_vos_tpu/models/transform.py` (RGB path). Equivalent of
torchvision's `GeneralizedRCNNTransform`: resize so the short side reaches
`min_size` unless the long side would pass `max_size`, ImageNet
normalization, and bottom/right zero padding to a canvas divisible by 64.
The resize is `F.interpolate(size=..., mode="bilinear", align_corners=False,
antialias=False)`, the call the JAX resize is held against in
`tests/test_torch_parity.py`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_scale(orig_hw: tuple[int, int], min_size: int = 800, max_size: int = 1333) -> float:
    """torchvision rule: scale min side to `min_size` unless the max side would
    exceed `max_size`."""
    h, w = orig_hw
    return min(min_size / min(h, w), max_size / max(h, w))


def resized_hw(orig_hw: tuple[int, int], min_size: int = 800, max_size: int = 1333) -> tuple[int, int]:
    """torchvision floors the scaled extent (DAVIS 480x854 -> 749x1333)."""
    s = resize_scale(orig_hw, min_size, max_size)
    return math.floor(orig_hw[0] * s), math.floor(orig_hw[1] * s)


def canvas_for(orig_hw: tuple[int, int], min_size: int = 800, max_size: int = 1333, divisor: int = 64) -> tuple[int, int]:
    """Static padded canvas: resized size rounded up to `divisor` (64 keeps the
    stride-64 P6 level exactly aligned)."""
    rh, rw = resized_hw(orig_hw, min_size, max_size)
    return -(-rh // divisor) * divisor, -(-rw // divisor) * divisor


@dataclasses.dataclass(frozen=True)
class ImageTransform:
    """Static-shape clip transform. All sizes resolved at construction."""

    original_hw: tuple[int, int]
    min_size: int = 800
    max_size: int = 1333
    divisor: int = 64

    @property
    def resized_hw(self) -> tuple[int, int]:
        return resized_hw(self.original_hw, self.min_size, self.max_size)

    @property
    def canvas_hw(self) -> tuple[int, int]:
        return canvas_for(self.original_hw, self.min_size, self.max_size, self.divisor)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: [T, H, W, 3], uint8 or float in [0,1] -> [T, Hc, Wc, 3]
        normalized float32 (an NHWC view of a channels-last NCHW tensor)."""
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        x = images.to(torch.float32)
        if images.dtype == torch.uint8:
            x = x / 255.0
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
        x = F.pad(x, (0, cw - rw, 0, ch - rh))
        return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

    @property
    def _box_ratios(self) -> tuple[float, float]:
        # Per-axis ratios of the *rounded* resized size, like torchvision's
        # resize_boxes.
        rh, rw = self.resized_hw
        h, w = self.original_hw
        return rh / h, rw / w

    def inverse_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """Canvas resolution -> original resolution (postprocess step)."""
        ry, rx = self._box_ratios
        return boxes / torch.tensor([rx, ry, rx, ry], dtype=boxes.dtype, device=boxes.device)
