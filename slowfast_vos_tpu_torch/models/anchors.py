"""FPN anchor generation, precomputed once per (static) canvas size.

Equivalent of torchvision's `AnchorGenerator` with the Mask R-CNN defaults the
reference inherits: one size per level (32..512), aspect ratios (0.5, 1, 2),
location-major / anchor-minor flattening so predictions reshape 1:1 from NHWC
conv outputs (SURVEY.md §2b). Anchors are static for a fixed canvas, so the
pipeline computes them once in numpy and keeps them on the device.

A copy of `slowfast_vos_tpu/models/anchors.py`: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import numpy as np

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)


def cell_anchors(size: float, ratios=ASPECT_RATIOS) -> np.ndarray:
    """[A, 4] zero-centered XYXY anchors, rounded like torchvision."""
    ratios = np.asarray(ratios, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


def grid_anchors(feature_hw: tuple[int, int], stride: int, size: float) -> np.ndarray:
    """[H*W*A, 4] anchors for one FPN level, location-major / anchor-minor."""
    h, w = feature_hw
    base = cell_anchors(size)  # [A, 4]
    shifts_x = np.arange(w, dtype=np.float32) * stride
    shifts_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # [H, W]
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # [H*W, 1, 4]
    return (shifts + base[None]).reshape(-1, 4)


def fpn_anchors(feature_hws, strides=(4, 8, 16, 32, 64), sizes=ANCHOR_SIZES):
    """Per-level anchor arrays for the whole pyramid."""
    return [
        grid_anchors(hw, stride, size)
        for hw, stride, size in zip(feature_hws, strides, sizes)
    ]
