"""Box primitives (XYXY convention) on torch tensors.

Port of `slowfast_vos_tpu/ops/boxes.py`. Every function takes boxes with any
number of leading batch dimensions; invalid (padded) boxes are handled by
the callers through validity masks, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

# torchvision BoxCoder clamps dw/dh at log(1000/16) before exp to avoid overflow.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] XYXY boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes1 [..., N, 4], boxes2 [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """Clip XYXY boxes to [0,W]x[0,H]. image_hw: (h, w) floats."""
    h, w = image_hw
    x1 = boxes[..., 0].clamp(0.0, w)
    y1 = boxes[..., 1].clamp(0.0, h)
    x2 = boxes[..., 2].clamp(0.0, w)
    y2 = boxes[..., 3].clamp(0.0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Boolean mask of boxes with both sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def _boxes_to_cxcywh(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode `reference` (gt) boxes relative to `proposals` (anchors/rois):
    t = (wx*(dx/w), wy*(dy/h), ww*log(gw/w), wh*log(gh/h))."""
    wx, wy, ww, wh = weights
    pcx, pcy, pw, ph = _boxes_to_cxcywh(proposals)
    gcx, gcy, gw, gh = _boxes_to_cxcywh(reference)
    pw = pw.clamp(min=1e-6)
    ph = ph.clamp(min=1e-6)
    tx = wx * (gcx - pcx) / pw
    ty = wy * (gcy - pcy) / ph
    tw = ww * torch.log(gw.clamp(min=1e-6) / pw)
    th = wh * torch.log(gh.clamp(min=1e-6) / ph)
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply regression `deltas` [..., 4] to anchor/proposal `boxes` [..., 4]."""
    wx, wy, ww, wh = weights
    pcx, pcy, pw, ph = _boxes_to_cxcywh(boxes)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    cx = dx * pw + pcx
    cy = dy * ph + pcy
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
