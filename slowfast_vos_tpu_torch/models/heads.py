"""RoI heads, inference: box head, mask head and detection postprocess.

Port of `slowfast_vos_tpu/models/heads.py` with torchvision's module tree
(`roi_heads.box_head.fc6`, `roi_heads.box_predictor.cls_score`,
`roi_heads.mask_head.mask_fcn1`, `roi_heads.mask_predictor.conv5_mask`, ...).
The box head flattens the pooled [N, 7, 7, C] in CHW order and the mask
head keeps a native `ConvTranspose2d`, so torchvision weights need neither
the fc6 reorder nor the deconv flip of the JAX converter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear, nchw, nhwc
from slowfast_vos_tpu_torch.ops.boxes import clip_boxes, decode_boxes, remove_small_boxes_mask
from slowfast_vos_tpu_torch.ops.nms import batched_nms_mask, top_k_after_nms


class BoxHead(nn.Module):
    """torchvision TwoMLPHead: [N, 7, 7, C] -> fc6 -> relu -> fc7 -> relu."""

    def __init__(self, in_channels: int = 256, pooled: int = 7, representation: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_channels * pooled * pooled, representation)
        self.fc7 = Linear(representation, representation)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = nchw(pooled).reshape(pooled.shape[0], -1)  # torch's CHW flatten
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    """torchvision FastRCNNPredictor: class logits and per-class box deltas."""

    def __init__(self, num_classes: int, representation: int = 1024):
        super().__init__()
        self.cls_score = Linear(representation, num_classes)
        self.bbox_pred = Linear(representation, num_classes * 4)

    def forward(self, x: torch.Tensor):
        cls = self.cls_score(x).float()
        reg = self.bbox_pred(x).float()
        return cls, reg.reshape(x.shape[0], -1, 4)


class MaskHead(nn.Module):
    """torchvision MaskRCNNHeads: 4x (3x3 conv 256 + relu), on NCHW."""

    def __init__(self, channels: int = 256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(channels, channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskPredictor(nn.Module):
    """torchvision MaskRCNNPredictor: deconv 2x2/2 + relu -> 1x1 conv logits."""

    def __init__(self, num_classes: int, channels: int = 256):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(channels, channels, 2, 2)
        self.mask_fcn_logits = Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class RoIHeads(nn.Module):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor(num_classes)
        self.mask_head = MaskHead()
        self.mask_predictor = MaskPredictor(num_classes)

    def box_predict(self, pooled: torch.Tensor):
        """[N, 7, 7, C] -> (class logits [N, K], box deltas [N, K, 4]), f32."""
        return self.box_predictor(self.box_head(pooled.to(self.dtype)))

    def mask_predict(self, pooled: torch.Tensor) -> torch.Tensor:
        """[N, 14, 14, C] -> mask logits [N, 28, 28, K], f32."""
        x = nchw(pooled.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        return nhwc(self.mask_predictor(self.mask_head(x))).float()


def postprocess_detections(
    class_logits: torch.Tensor,
    box_regression: torch.Tensor,
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    image_hw,
    cfg: DetectionConfig,
):
    """torchvision `postprocess_detections`, static shapes, batched over any
    leading dimensions (`heads.py:240-267` per frame): softmax, per-class
    decode, clip, score threshold, min size, class-keyed NMS, top
    `detections_per_img`.

    class_logits [..., P, K], box_regression [..., P, K, 4], proposals
    [..., P, 4], prop_valid [..., P] -> (boxes [..., D, 4], scores [..., D],
    labels [..., D] int32, valid [..., D])."""
    num_classes = class_logits.shape[-1]
    lead, p = proposals.shape[:-2], proposals.shape[-2]
    scores = torch.softmax(class_logits, dim=-1)
    boxes = decode_boxes(box_regression, proposals[..., :, None, :], cfg.bbox_reg_weights)
    boxes = clip_boxes(boxes, image_hw)

    # Drop the background column, flatten classes.
    fg_boxes = boxes[..., 1:, :].reshape(*lead, -1, 4)
    fg_scores = scores[..., 1:].reshape(*lead, -1)
    labels = torch.arange(1, num_classes, dtype=torch.int32, device=proposals.device).repeat(p)
    fg_labels = labels.expand(*lead, -1)
    fg_valid = prop_valid.repeat_interleave(num_classes - 1, dim=-1)

    valid = fg_valid & (fg_scores > cfg.box_score_thresh) & remove_small_boxes_mask(fg_boxes, cfg.box_min_size)
    keep, _order = batched_nms_mask(fg_boxes, fg_scores, fg_labels, valid, iou_threshold=cfg.box_nms_thresh)
    idx, out_valid = top_k_after_nms(keep, fg_scores, cfg.detections_per_img)
    out_boxes = torch.gather(fg_boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return out_boxes, torch.gather(fg_scores, -1, idx), torch.gather(fg_labels, -1, idx), out_valid


def postprocess_detections_single(class_logits, box_regression, proposals, prop_valid, image_hw, cfg):
    """One image: class_logits [P, K], ... -> boxes [D, 4], scores, labels, valid."""
    out = postprocess_detections(
        class_logits[None], box_regression[None], proposals[None], prop_valid[None], image_hw, cfg
    )
    return tuple(o[0] for o in out)
