"""Image preprocessing: normalize, resize, pad to a static canvas.

Port of `slowfast_vos_tpu/models/transform.py`. Equivalent of torchvision's
`GeneralizedRCNNTransform`: resize so the short side reaches `min_size`
unless the long side would pass `max_size`, ImageNet normalization, and
bottom/right zero padding to a canvas divisible by 64. The resize is
`F.interpolate(size=..., mode="bilinear", align_corners=False,
antialias=False)`, the call the JAX resize is held against in
`tests/test_torch_parity.py`.

Frames reach the device either as RGB (`ImageTransform.__call__`) or as
planar YUV 4:2:0 (`rgb_to_yuv420` on the host, `ImageTransform.from_yuv420`
on the device), half the bytes of RGB with the chroma loss of a 4:2:0 JPEG.
Both give the same canvas layout.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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

    def _to_canvas(self, x: torch.Tensor) -> torch.Tensor:
        """[T, 3, H, W] float32 RGB in [0, 1] -> normalized, resized to
        `resized_hw`, zero-padded to `canvas_hw`: [T, Hc, Wc, 3] (an NHWC
        view of a channels-last NCHW tensor)."""
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)[:, None, None]
        x = F.interpolate((x - mean) / std, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
        x = F.pad(x, (0, cw - rw, 0, ch - rh))
        return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: [T, H, W, 3], uint8 or float in [0,1] -> [T, Hc, Wc, 3]
        normalized float32 (an NHWC view of a channels-last NCHW tensor)."""
        x = images.to(torch.float32)
        if images.dtype == torch.uint8:
            x = x / 255.0
        return self._to_canvas(x.permute(0, 3, 1, 2))

    def from_yuv420(self, y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        """YUV 4:2:0 planes -> the same normalized canvas as `__call__`
        (JAX `transform.py:106-135`).

        y: [T, H, W] uint8 luma; uv: [T, H/2, W/2, 2] uint8 chroma (Cb, Cr),
        as `rgb_to_yuv420` makes them. The chroma is upsampled 2x
        (bilinear, half-pixel centres), then studio-range BT.601 YCbCr
        (Y in [16, 235], chroma excursion 224: what OpenCV's RGB2YUV_I420
        emits) goes to RGB, clipped to [0, 255]."""
        h, w = y.shape[1:]
        yf = (y.to(torch.float32) - 16.0) * (255.0 / 219.0)
        uvf = F.interpolate(
            uv.to(torch.float32).permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False, antialias=False
        ) - 128.0
        cb = uvf[:, 0] * (255.0 / 224.0)
        cr = uvf[:, 1] * (255.0 / 224.0)
        r = yf + 1.402 * cr
        g = yf - 0.344136 * cb - 0.714136 * cr
        b = yf + 1.772 * cb
        return self._to_canvas(torch.stack([r, g, b], dim=1).clamp(0.0, 255.0) / 255.0)

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
        return boxes * torch.tensor([rx, ry, rx, ry], dtype=boxes.dtype, device=boxes.device)

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
        return boxes / torch.tensor([rx, ry, rx, ry], dtype=boxes.dtype, device=boxes.device)


def rgb_to_yuv420(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side RGB -> planar YUV 4:2:0 with OpenCV (JAX
    `transform.py:177-197`); `ImageTransform.from_yuv420` decodes it.

    images: [T, H, W, 3] uint8 with even H, W. Returns (y [T, H, W] uint8,
    uv [T, H/2, W/2, 2] uint8, Cb then Cr)."""
    import cv2

    t, h, w = images.shape[:3]
    if h % 2 or w % 2:
        raise ValueError(f"YUV 4:2:0 transport needs even H, W, not {h}x{w}")
    y = np.empty((t, h, w), np.uint8)
    uv = np.empty((t, h // 2, w // 2, 2), np.uint8)
    qh = h // 4  # I420 chroma plane rows in the stacked [H*3/2, W] layout
    for i in range(t):
        i420 = cv2.cvtColor(images[i], cv2.COLOR_RGB2YUV_I420)  # [H*3/2, W]
        y[i] = i420[:h]
        uv[i, :, :, 0] = i420[h : h + qh].reshape(h // 2, w // 2)
        uv[i, :, :, 1] = i420[h + qh :].reshape(h // 2, w // 2)
    return y, uv
