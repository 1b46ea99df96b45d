"""RoI heads: box head, mask head, detection postprocess, and the training
sample selection and losses.

Port of `slowfast_vos_tpu/models/heads.py` with torchvision's module tree
(`roi_heads.box_head.fc6`, `roi_heads.box_predictor.cls_score`,
`roi_heads.mask_head.mask_fcn1`, `roi_heads.mask_predictor.conv5_mask`, ...).
The box head flattens the pooled [N, 7, 7, C] in CHW order and the mask
head keeps a native `ConvTranspose2d`, so torchvision weights need neither
the fc6 reorder nor the deconv flip of the JAX converter. The training
functions are batched over a leading frame dimension where JAX vmaps them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.layers import LN_EPS, Conv2d, ConvTranspose2d, Linear, channel_norm, nchw, nhwc
from slowfast_vos_tpu_torch.models.matching import BELOW_LOW, match_to_gt, sample_balanced
from slowfast_vos_tpu_torch.models.rpn import smooth_l1
from slowfast_vos_tpu_torch.ops.boxes import box_iou, clip_boxes, decode_boxes, encode_boxes, remove_small_boxes_mask
from slowfast_vos_tpu_torch.ops.constants import device_constant
from slowfast_vos_tpu_torch.ops.nms import batched_nms_mask, sort_desc, top_k_after_nms
from slowfast_vos_tpu_torch.ops.roi_align import interp_matrix_1d


class BoxHead(nn.Module):
    """torchvision TwoMLPHead: [N, 7, 7, C] -> fc6 -> relu -> fc7 -> relu."""

    def __init__(self, in_channels: int = 256, pooled: int = 7, representation: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_channels * pooled * pooled, representation)
        self.fc7 = Linear(representation, representation)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = nchw(pooled).reshape(pooled.shape[0], -1)  # torch's CHW flatten
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class ConvBoxHead(nn.Module):
    """detectron2's FastRCNNConvFCHead with `conv_norm="LN"` (ViTDet's
    4conv1fc): [N, 7, 7, C] -> 4x (3x3 conv without bias, channel LayerNorm,
    relu) -> torch's CHW flatten -> fc 1024 -> relu."""

    def __init__(self, in_channels: int = 256, pooled: int = 7, representation: int = 1024, convs: int = 4):
        super().__init__()
        self.convs = convs
        for i in range(1, convs + 1):
            self.add_module(f"conv{i}", Conv2d(in_channels, in_channels, 3, padding=1, bias=False))
            self.add_module(f"norm{i}", nn.LayerNorm(in_channels, eps=LN_EPS))
        self.fc1 = Linear(in_channels * pooled * pooled, representation)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = nchw(pooled).contiguous(memory_format=torch.channels_last)
        for i in range(1, self.convs + 1):
            x = F.relu(channel_norm(getattr(self, f"conv{i}")(x), getattr(self, f"norm{i}")))
        return F.relu(self.fc1(x.contiguous().flatten(1)))  # torch's CHW flatten


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
    """torchvision MaskRCNNHeads: 4x (3x3 conv 256 + relu), on NCHW. With
    `norm="ln"` (ViTDet's head, detectron2 `conv_norm="LN"`) each conv has
    no bias and a channel LayerNorm `mask_fcn<i>_norm` before its relu."""

    def __init__(self, channels: int = 256, norm: str | None = None):
        super().__init__()
        self.norm = norm
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(channels, channels, 3, padding=1, bias=norm is None))
            if norm == "ln":
                self.add_module(f"mask_fcn{i}_norm", nn.LayerNorm(channels, eps=LN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = getattr(self, f"mask_fcn{i}")(x)
            if self.norm == "ln":
                x = channel_norm(x, getattr(self, f"mask_fcn{i}_norm"))
            x = F.relu(x)
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
    """`vitdet=True`: ViTDet's 4conv1fc box head and LayerNorm mask head,
    with torchvision's predictors."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16, vitdet: bool = False):
        super().__init__()
        self.dtype = dtype
        self.box_head = ConvBoxHead() if vitdet else BoxHead()
        self.box_predictor = BoxPredictor(num_classes)
        self.mask_head = MaskHead(norm="ln" if vitdet else None)
        self.mask_predictor = MaskPredictor(num_classes)

    def box_predict(self, pooled: torch.Tensor):
        """[N, 7, 7, C] -> (class logits [N, K], box deltas [N, K, 4]), f32."""
        return self.box_predictor(self.box_head(pooled.to(self.dtype)))

    def mask_predict(self, pooled: torch.Tensor) -> torch.Tensor:
        """[N, 14, 14, C] -> mask logits [N, 28, 28, K], f32."""
        x = nchw(pooled.to(self.dtype)).contiguous(memory_format=torch.channels_last)
        return nhwc(self.mask_predictor(self.mask_head(x))).float()


def masks_to_sorted_indices(pos_mask: torch.Tensor, neg_mask: torch.Tensor, total: int):
    """Static gather order (`heads.py:116-121`): positives first, then
    negatives, then padding, the lower index first within each (a stable
    descending sort of scores in {0, 1, 2}, as `lax.top_k` orders ties).
    Returns (indices, is_positive, valid), each [..., total]."""
    score = pos_mask.to(torch.int32) * 2 + neg_mask.to(torch.int32)
    top, idx = sort_desc(score)
    top, idx = top[..., :total], idx[..., :total]
    return idx, top == 2, top > 0


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., n, *rest] gathered at idx [..., k] along the candidate axis."""
    rest = x.shape[idx.dim():]
    return torch.gather(x, idx.dim() - 1, idx.reshape(*idx.shape, *[1] * len(rest)).expand(*idx.shape, *rest))


def select_training_samples(
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: DetectionConfig,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """torchvision `RoIHeads.select_training_samples` (`heads.py:124-169`):
    gt boxes appended to the proposals, matched at fg = bg = 0.5 with no
    low-quality matches, `box_batch_size_per_image` rois sampled at
    `box_positive_fraction`, positives first.

    proposals [..., P, 4], prop_valid [..., P], gt_boxes [..., G, 4],
    gt_labels [..., G], gt_valid [..., G]; u_pos, u_neg [..., P + G]:
    uniform draws of the sampler. Returns [..., B] tensors (B =
    min(box_batch_size_per_image, P + G)): boxes, labels, reg_targets,
    matched_gt (index into gt), is_pos, valid."""
    props = torch.cat([proposals, gt_boxes], dim=-2)
    pvalid = torch.cat([prop_valid, gt_valid], dim=-1)
    iou = box_iou(props, gt_boxes)
    iou = torch.where(pvalid[..., None], iou, torch.full_like(iou, -1.0))
    matches = match_to_gt(
        iou, gt_valid, high_threshold=cfg.box_fg_iou, low_threshold=cfg.box_bg_iou, allow_low_quality=False
    )
    positive = (matches >= 0) & pvalid
    negative = (matches == BELOW_LOW) & pvalid
    pos_mask, neg_mask = sample_balanced(
        positive, negative, u_pos, u_neg,
        batch_size=cfg.box_batch_size_per_image, positive_fraction=cfg.box_positive_fraction,
    )
    total = min(cfg.box_batch_size_per_image, props.shape[-2])
    idx, is_pos, valid = masks_to_sorted_indices(pos_mask, neg_mask, total)

    boxes = _take(props, idx)
    matched = torch.gather(matches, -1, idx).clamp(min=0)
    labels = torch.where(is_pos, torch.gather(gt_labels, -1, matched), torch.zeros_like(matched))
    reg_targets = encode_boxes(_take(gt_boxes, matched), boxes, cfg.bbox_reg_weights)
    return {
        "boxes": boxes,
        "labels": labels,
        "reg_targets": reg_targets,
        "matched_gt": matched,
        "is_pos": is_pos,
        "valid": valid,
    }


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor, samples: dict):
    """Cross-entropy over the sampled rois and smooth-l1 (beta 1/9) over the
    positives, both over the number sampled (`heads.py:172-185`).

    class_logits [..., B, K], box_regression [..., B, K, 4] -> per-frame
    (cls_loss [...], box_loss [...])."""
    labels = samples["labels"].long()
    valid = samples["valid"]
    num = valid.sum(-1).clamp(min=1)
    zero = torch.zeros((), device=class_logits.device)
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    cls_loss = torch.where(valid, ce, zero).sum(-1) / num
    reg = torch.gather(box_regression, -2, labels[..., None, None].expand(*labels.shape, 1, 4))[..., 0, :]
    bl = smooth_l1(reg - samples["reg_targets"], beta=1.0 / 9.0).sum(-1)
    box_loss = torch.where(samples["is_pos"], bl, zero).sum(-1) / num
    return cls_loss, box_loss


def project_masks_on_boxes(mask_stack: torch.Tensor, gt_idx: torch.Tensor, boxes: torch.Tensor, out_size: int):
    """Gt masks sampled at roi boxes into [..., R, out, out] targets
    (`heads.py:188-222`): torchvision's roi_align(spatial_scale=1) with a
    fixed sampling ratio of 2, as the dense separable product
    A_y . mask[gt] . A_x^T of `interp_matrix_1d` matrices.

    mask_stack [..., G, H, W] (0/1), gt_idx [..., R], boxes [..., R, 4]."""
    h, w = mask_stack.shape[-2:]
    lead = boxes.shape[:-2]
    r = boxes.shape[-2]
    b = boxes.reshape(-1, 4).to(torch.float32)
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    out_t = device_constant(float(out_size), torch.float32, boxes.device)
    a_y = interp_matrix_1d(y1, (y2 - y1).clamp(min=1.0) / out_t, h, out_size, 2)  # [M, out, H]
    a_x = interp_matrix_1d(x1, (x2 - x1).clamp(min=1.0) / out_t, w, out_size, 2)  # [M, out, W]
    stack = mask_stack.reshape(-1, *mask_stack.shape[-3:]).to(torch.float32)  # [L, G, H, W]
    gi = gt_idx.reshape(stack.shape[0], r)
    frame = torch.arange(stack.shape[0], device=gi.device)[:, None]
    msel = stack[frame, gi].reshape(-1, h, w)  # [M, H, W] plane select
    out = torch.bmm(torch.bmm(a_y, msel), a_x.transpose(1, 2))
    return out.reshape(*lead, r, out_size, out_size)


def maskrcnn_loss(mask_logits: torch.Tensor, targets: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor):
    """BCE-with-logits of the gt class's channel against the projected
    targets, mean over the pixels of the valid positive rois
    (`heads.py:225-237`). mask_logits [..., R, M, M, K], targets
    [..., R, M, M], labels and valid [..., R] -> per-frame loss [...]."""
    m = mask_logits.shape[-2]
    idx = labels.long()[..., None, None, None].expand(*labels.shape, m, m, 1)
    sel = torch.gather(mask_logits, -1, idx)[..., 0]
    bce = sel.clamp(min=0) - sel * targets + torch.log1p(torch.exp(-sel.abs()))
    per_roi = bce.mean(dim=(-2, -1))
    num = valid.sum(-1).clamp(min=1)
    return torch.where(valid, per_roi, torch.zeros((), device=per_roi.device)).sum(-1) / num


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
