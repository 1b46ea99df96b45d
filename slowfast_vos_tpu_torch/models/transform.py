"""Image preprocessing: normalize, resize, pad to a static canvas.

Port of `slowfast_vos_tpu/models/transform.py`. Equivalent of torchvision's
`GeneralizedRCNNTransform`: resize so the short side reaches `min_size`
unless the long side would pass `max_size`, ImageNet normalization, and
bottom/right zero padding to a canvas divisible by 64. The resize is
`F.interpolate(size=..., mode="bilinear", align_corners=False,
antialias=False)`, the call the JAX resize is held against in
`tests/test_torch_parity.py`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from slowfast_vos_tpu_torch.ops.constants import device_constant

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


def resized_hw_rounded(orig_hw: tuple[int, int], min_size: int, max_size: int) -> tuple[int, int]:
    """detectron2's `ResizeShortestEdge.get_output_shape`: the short side to
    `min_size`, then both scaled down if the long side passes `max_size`,
    each rounded as `int(x + 0.5)` (DAVIS 480x854 at 1024 -> 576x1024)."""
    h, w = orig_hw
    scale = min_size / min(h, w)
    newh, neww = (min_size, scale * w) if h < w else (scale * h, min_size)
    if max(newh, neww) > max_size:
        scale = max_size / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def canvas_for(orig_hw: tuple[int, int], min_size: int = 800, max_size: int = 1333, divisor: int = 64) -> tuple[int, int]:
    """Static padded canvas: resized size rounded up to `divisor` (64 keeps the
    stride-64 P6 level exactly aligned)."""
    rh, rw = resized_hw(orig_hw, min_size, max_size)
    return -(-rh // divisor) * divisor, -(-rw // divisor) * divisor


@dataclasses.dataclass(frozen=True)
class ImageTransform:
    """Static-shape clip transform. All sizes resolved at construction.

    `square`: ViTDet's input (detectron2 `ResizeShortestEdge(min_size,
    max_size)` and `square_pad`): the resized extent rounded as detectron2
    rounds it (`resized_hw_rounded`) and a `square` x `square` canvas,
    zero padded after the normalization as the default canvas is."""

    original_hw: tuple[int, int]
    min_size: int = 800
    max_size: int = 1333
    divisor: int = 64
    square: int | None = None

    @property
    def resized_hw(self) -> tuple[int, int]:
        if self.square:
            return resized_hw_rounded(self.original_hw, self.min_size, self.max_size)
        return resized_hw(self.original_hw, self.min_size, self.max_size)

    @property
    def canvas_hw(self) -> tuple[int, int]:
        if self.square:
            rh, rw = self.resized_hw
            if max(rh, rw) > self.square:
                raise ValueError(f"a {rh}x{rw} image does not fit the {self.square} square canvas")
            return self.square, self.square
        return canvas_for(self.original_hw, self.min_size, self.max_size, self.divisor)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: [T, H, W, 3], uint8 or float in [0,1] -> normalized,
        resized to `resized_hw`, zero-padded to `canvas_hw`: [T, Hc, Wc, 3]
        float32 (an NHWC view of a channels-last NCHW tensor)."""
        x = images.to(torch.float32)
        if images.dtype == torch.uint8:
            x = x / 255.0
        x = x.permute(0, 3, 1, 2)
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        mean = device_constant(IMAGENET_MEAN, torch.float32, x.device)[:, None, None]
        std = device_constant(IMAGENET_STD, torch.float32, x.device)[:, None, None]
        x = F.interpolate((x - mean) / std, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
        x = F.pad(x, (0, cw - rw, 0, ch - rh))
        return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

    @property
    def _box_ratios(self) -> tuple[float, float]:
        # Per-axis ratios of the *rounded* resized size, like torchvision's
        # resize_boxes.
        rh, rw = self.resized_hw
        h, w = self.original_hw
        return rh / h, rw / w

    def transform_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """Original-resolution XYXY -> canvas resolution (`transform.py:158-161`)."""
        ry, rx = self._box_ratios
        return boxes * device_constant((rx, ry, rx, ry), boxes.dtype, boxes.device)

    def masks_to_canvas(self, masks: torch.Tensor) -> torch.Tensor:
        """Binary gt masks [..., H, W] at the original resolution -> float32
        0/1 masks [..., Hc, Wc] on the canvas: bilinear resize to the resized
        extent, threshold at >= 0.5, zero padding bottom and right (the
        train step's resize, `train_step.py:285-295`).

        `jax.image.resize` antialiases when it shrinks an image and
        `F.interpolate(antialias=False)` does not; both enlarge alike. DAVIS
        480p and the test shapes enlarge, so the two agree there."""
        h, w = masks.shape[-2:]
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        x = masks.reshape(-1, 1, h, w).to(torch.float32)
        x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
        x = F.pad((x >= 0.5).to(torch.float32), (0, cw - rw, 0, ch - rh))
        return x.reshape(*masks.shape[:-2], ch, cw)

    def inverse_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """Canvas resolution -> original resolution (postprocess step)."""
        ry, rx = self._box_ratios
        return boxes / device_constant((rx, ry, rx, ry), boxes.dtype, boxes.device)
